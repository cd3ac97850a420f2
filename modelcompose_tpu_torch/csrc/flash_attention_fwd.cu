// Flash-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel modelcompose_tpu/ops/flash_attention.py
// `_fa_kernel` (driven by `_flash_attention_forward`):
//     O = softmax(Q K^T * scale + mask) V   and   LSE = m + log(l)
// with the mask = same segment, kv segment != 0, and (causal)
// q_offset + i >= j.  Padding rows (segment 0) come out as the mean of V,
// as on the TPU; callers ignore them.
//
// What bounds it on the H100: tensor-core FLOPs.  At the prefill bucket
// (Lq = S = 1024, D = 128) each (b, h) does 4*Lq*S*D/2 flops over only
// 3*S*D*2 bytes of q/k/v, far above the ~295 flop/byte ridge.  The design
// keeps the S = QK^T and P tiles in registers (mma.sync m16n8k16, bf16
// operands, fp32 accumulators, online softmax in fp32) so nothing of size
// Lq*S ever reaches device memory, and skips kv tiles wholly in the
// future.  This first version is simple: one block per (64-row q tile,
// head, batch), 4 warps of 16 q rows each, K/V tiles staged through shared
// memory with plain 16-byte loads and no double buffering.  wgmma and TMA
// come later.
//
// Layouts (the JAX package's public layout, no padding, no lifted
// segment ids): q [B, Lq, H, D], k/v [B, S, Hkv, D], all bf16 and
// contiguous; segment ids int32 [B, Lq] / [B, S]; out [B, Lq, H, D] bf16;
// lse [B, H, Lq] fp32.  GQA: kv head = h / (H / Hkv).  D in {64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr int smem_bytes() {
  return (kBlockQ + 2 * kBlockK) * (D + 8) * 2 + kBlockK * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              int H, int Hkv, int Lq, int S, float sm_scale, int causal,
              int q_offset) {
  // Rows padded by 8 bf16 (16 bytes) so the fragment loads of a warp hit
  // 32 distinct banks.
  constexpr int LD = D + 8;
  constexpr int kVec = 8;            // bf16 per 16-byte load
  constexpr int kChunks = D / kVec;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBlockQ * LD;
  __nv_bfloat16* sV = sK + kBlockK * LD;
  int* sSeg = reinterpret_cast<int*>(sV + kBlockK * LD);

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma "groupID": fragment row
  const int t4 = lane & 3;  // mma thread-in-group: fragment column pair

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + (long)b * Lq * q_stride + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * S * kv_stride + (long)hk * D;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 val = zero;
    if (q0 + r < Lq)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_stride + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  __syncthreads();

  // This warp's 16 q rows as A fragments, held for the whole kv loop.
  const int wrow = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = sQ + (wrow + g) * LD + kk * 16 + t4 * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  // The two q rows this thread owns in the accumulator layout.
  const int r0 = q0 + wrow + g;
  const int r1 = r0 + 8;
  const int seg0 = r0 < Lq ? q_seg[(long)b * Lq + r0] : 0;
  const int seg1 = r1 < Lq ? q_seg[(long)b * Lq + r1] : 0;
  const int pos0 = q_offset + r0;
  const int pos1 = q_offset + r1;

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  if (causal) {  // skip kv tiles wholly in the future of every row
    const int last_q = q_offset + q0 + kBlockQ - 1;
    n_tiles = min(n_tiles, last_q / kBlockK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kVec;
      uint4 kval = zero, vval = zero;  // zero rows past S: 0 * V, not NaN
      if (k0 + r < S) {
        kval = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_stride + c);
        vval = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kval;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vval;
    }
    if (tid < kBlockK)
      sSeg[tid] = k0 + tid < S ? kv_seg[(long)b * S + k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, 8 n-tiles of 8 kv columns.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
        const __nv_bfloat16* p = sK + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(p);
        bf[1] = *reinterpret_cast<const uint32_t*>(p + 8);
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    // Scale, mask, and the online-softmax update in fp32.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + t4 * 2 + e;
        const int kseg = sSeg[col];
        const int kpos = k0 + col;
        const bool ok0 = kseg != 0 && kseg == seg0 && (!causal || pos0 >= kpos);
        const bool ok1 = kseg != 0 && kseg == seg1 && (!causal || pos1 >= kpos);
        s[nt][e] = ok0 ? s[nt][e] * sm_scale : kNegInf;
        s[nt][2 + e] = ok1 ? s[nt][2 + e] * sm_scale : kNegInf;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // O += P V with P cast to bf16 (the JAX kernel's _gemm2_cast).  The
    // S accumulator layout is the A-fragment layout of P, two n-tiles per
    // 16-wide k step.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* p = sV + (kk * 16 + t4 * 2) * LD + dt * 8 + g;
        uint32_t bf[2];
        bf[0] = pack_bf16(p[0], p[LD]);
        bf[1] = pack_bf16(p[8 * LD], p[9 * LD]);
        mma_16816(o[dt], pa, bf);
      }
    }
  }

  const float sl0 = l0 == 0.f ? 1.f : l0;
  const float sl1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* ob = out + (long)b * Lq * q_stride + (long)h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_f32(o[dt][0] / sl0, o[dt][1] / sl0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_f32(o[dt][2] / sl1, o[dt][3] / sl1);
  }
  if (t4 == 0) {
    float* lb = lse + ((long)b * H + h) * Lq;
    if (r0 < Lq) lb[r0] = m0 + logf(sl0);
    if (r1 < Lq) lb[r1] = m1 + logf(sl1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_seg, const void* kv_seg, void* out,
                   void* lse, int B, int H, int Hkv, int Lq, int S,
                   float sm_scale, int causal, int q_offset,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  fa_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Hkv, Lq, S, sm_scale, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mc_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* q_seg,
                                      const void* kv_seg, void* out,
                                      void* lse, int B, int H, int Hkv,
                                      int Lq, int S, int D, float sm_scale,
                                      int causal, int q_offset,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Lq <= 0 || S <= 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, Lq, S,
                       sm_scale, causal, q_offset, s);
  if (D == 64)
    return launch<64>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, Lq, S,
                      sm_scale, causal, q_offset, s);
  return cudaErrorInvalidValue;
}
