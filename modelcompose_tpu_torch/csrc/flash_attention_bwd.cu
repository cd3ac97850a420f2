// Flash-attention backward (kernels K3 and K4) for Hopper, sm_90a.
//
// K3 replaces the Pallas TPU kernel modelcompose_tpu/ops/flash_attention.py
// `_bwd_dq_kernel`, K4 replaces `_bwd_dkv_kernel` (both driven by
// `_flash_attention_backward`).  With P = exp(S * scale - LSE) under the
// mask (same segment, kv segment != 0, causal q_offset + i >= j) and
// Di = rowsum(O * dO) computed by the wrapper:
//     dP = dO V^T,  dS = P * (dP - Di) * scale,
//     K3: dQ = dS K            K4: dV = P^T dO,  dK = dS^T Q
// The mask is a select, not an underflow: a padding row's LSE is about
// -1e30, so exp(S - LSE) there is not 0 and must be masked explicitly.
//
// What bounds it on the H100: tensor-core FLOPs, as for the forward (K1).
// Each (q tile, kv tile) pair does four 64x64xD products in K4 (S, dP, dV,
// dK) and three in K3 (S, dP, dQ), over bytes that are read once per tile.
// Nothing of size Lq*S reaches device memory: S, P, dP and dS live in
// registers as mma.sync m16n8k16 accumulators (bf16 operands, fp32
// accumulation), and the accumulator layout of S and dS is already the
// A-fragment layout of the second product, as P is for P.V in K1.
//
// Design, simple first:
// - K3: one block per (64-row q tile, q head, batch), 4 warps of 16 q rows.
//   Q and dO tiles stay in shared memory; the block loops over kv tiles,
//   skipping those wholly in the causal future (the Pallas `_causal_skip`
//   with q_offset), and keeps the dQ accumulator in fp32 registers.
// - K4: one block per (64-row kv tile, KV head, batch), 4 warps of 16 kv
//   rows.  It loops over the q heads of its GQA group and over the q tiles
//   from the first one that can see this kv tile, so the group sum of the
//   JAX wrapper happens in registers: dK/dV are written once as
//   [B, S, Hkv, D], with no atomics and no [B, H, S, D] buffer, and the
//   result is deterministic.
// - Numerics of the bf16-operand contract: P is cast to bf16 before
//   dV += P^T dO, dS is cast to bf16 before dK += dS^T Q and dQ += dS K;
//   the accumulators are fp32 and dQ/dK/dV are written as bf16.
// - Tiles are staged through shared memory with plain 16-byte loads, no
//   double buffering; wgmma and TMA are later work.
//
// Layouts (the JAX package's public layout): q, dO [B, Lq, H, D];
// k, v [B, S, Hkv, D], all bf16 and contiguous; LSE, Di fp32 [B, H, Lq];
// segment ids int32 [B, Lq] / [B, S]; dq [B, Lq, H, D], dk/dv
// [B, S, Hkv, D] bf16.  GQA: kv head = h / (H / Hkv).  D in {64, 128}.
// Rows past Lq or S are zero-filled and masked (their segment is 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // rows a block owns: q rows (K3), kv rows (K4)
constexpr int kThreads = 128;  // 4 warps x 16 rows

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

// Copy `rows` rows of a bf16 matrix with row stride `stride` (elements),
// starting at row r0, into shared memory with leading dimension D + 8;
// rows at or past `limit` are zero (0 * x, never NaN).
template <int D, int rows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long stride, int r0, int limit,
                                          int tid) {
  constexpr int LD = D + 8;  // 16 bytes of padding: conflict-free fragments
  constexpr int kChunks = D / 8;
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// acc[16 x 8*NT] += A B^T for this warp: A is 16 rows of sA from row
// a_row, B is the 8*NT rows of sB; both are [rows, D] in shared memory,
// the contraction runs over D.
template <int D, int NT>
__device__ __forceinline__ void gemm_abt(float acc[NT][4],
                                         const __nv_bfloat16* sA, int a_row,
                                         const __nv_bfloat16* sB, int g,
                                         int t4) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* pa = sA + (a_row + g) * LD + kk * 16 + t4 * 2;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(pa);
    a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * LD);
    a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* pb = sB + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(pb);
      b[1] = *reinterpret_cast<const uint32_t*>(pb + 8);
      mma_16816(acc[nt], a, b);
    }
  }
}

// out[16 x D] += P sB for this warp: P is a 16 x 8*NT fp32 accumulator
// (cast to bf16 here), sB holds 8*NT rows of [rows, D]; the contraction
// runs over those rows.  The accumulator layout of two neighbouring n-tiles
// is the A-fragment layout of one 16-wide k step.
template <int D, int NT>
__device__ __forceinline__ void gemm_pb(float out[D / 8][4],
                                        float p[NT][4],
                                        const __nv_bfloat16* sB, int g,
                                        int t4) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* pb = sB + (kk * 16 + t4 * 2) * LD + dt * 8 + g;
      uint32_t b[2];
      b[0] = pack_bf16(pb[0], pb[LD]);
      b[1] = pack_bf16(pb[8 * LD], pb[9 * LD]);
      mma_16816(out[dt], a, b);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long stride,
                                           int r0, int r1, int limit,
                                           float acc[D / 8][4],
                                           int t4) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < limit)
      *reinterpret_cast<uint32_t*>(base + r0 * stride + c) =
          pack_f32(acc[dt][0], acc[dt][1]);
    if (r1 < limit)
      *reinterpret_cast<uint32_t*>(base + r1 * stride + c) =
          pack_f32(acc[dt][2], acc[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// K3: dQ
// ---------------------------------------------------------------------------

constexpr int kTileK3 = 64;  // kv columns per inner tile

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBlockM + 2 * kTileK3) * (D + 8) * 2 + kTileK3 * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg,
                 __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Lq,
                 int S, float sm_scale, int causal, int q_offset) {
  constexpr int LD = D + 8;
  constexpr int NT = kTileK3 / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kBlockM * LD;
  __nv_bfloat16* sK = sdO + kBlockM * LD;
  __nv_bfloat16* sV = sK + kTileK3 * LD;
  int* sSeg = reinterpret_cast<int*>(sV + kTileK3 * LD);

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma groupID: fragment row
  const int t4 = lane & 3;  // mma thread-in-group: fragment column pair

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long q_off = (long)b * Lq * q_stride + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * S * kv_stride + (long)hk * D;

  load_tile<D, kBlockM>(sQ, q + q_off, q_stride, q0, Lq, tid);
  load_tile<D, kBlockM>(sdO, dout + q_off, q_stride, q0, Lq, tid);

  // The two q rows this thread owns in the accumulator layout.
  const int wrow = warp * 16;
  const int r0 = q0 + wrow + g;
  const int r1 = r0 + 8;
  const long row_base = ((long)b * H + h) * Lq;
  const int seg0 = r0 < Lq ? q_seg[(long)b * Lq + r0] : 0;
  const int seg1 = r1 < Lq ? q_seg[(long)b * Lq + r1] : 0;
  const float lse0 = r0 < Lq ? lse[row_base + r0] : 0.f;
  const float lse1 = r1 < Lq ? lse[row_base + r1] : 0.f;
  const float di0 = r0 < Lq ? di[row_base + r0] : 0.f;
  const float di1 = r1 < Lq ? di[row_base + r1] : 0.f;
  const int pos0 = q_offset + r0;
  const int pos1 = q_offset + r1;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int n_tiles = (S + kTileK3 - 1) / kTileK3;
  if (causal) {  // skip kv tiles wholly in the future of every row
    const int last_q = q_offset + q0 + kBlockM - 1;
    n_tiles = min(n_tiles, last_q / kTileK3 + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTileK3;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kTileK3>(sK, kb, kv_stride, k0, S, tid);
    load_tile<D, kTileK3>(sV, vb, kv_stride, k0, S, tid);
    if (tid < kTileK3)
      sSeg[tid] = k0 + tid < S ? kv_seg[(long)b * S + k0 + tid] : 0;
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    gemm_abt<D, NT>(s, sQ, wrow, sK, g, t4);    // S = Q K^T
    gemm_abt<D, NT>(dp, sdO, wrow, sV, g, t4);  // dP = dO V^T

    // dS = P (dP - Di) scale with P = where(mask, exp(S scale - LSE), 0).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + t4 * 2 + e;
        const int kseg = sSeg[col];
        const int kpos = k0 + col;
        const bool ok0 = kseg != 0 && kseg == seg0 && (!causal || pos0 >= kpos);
        const bool ok1 = kseg != 0 && kseg == seg1 && (!causal || pos1 >= kpos);
        const float p0 = ok0 ? expf(s[nt][e] * sm_scale - lse0) : 0.f;
        const float p1 = ok1 ? expf(s[nt][2 + e] * sm_scale - lse1) : 0.f;
        s[nt][e] = p0 * (dp[nt][e] - di0) * sm_scale;
        s[nt][2 + e] = p1 * (dp[nt][2 + e] - di1) * sm_scale;
      }
    }
    gemm_pb<D, NT>(acc, s, sK, g, t4);  // dQ += dS K (dS cast to bf16)
  }

  store_rows<D>(dq + q_off, q_stride, r0, r1, Lq, acc, t4);
}

// ---------------------------------------------------------------------------
// K4: dK, dV
// ---------------------------------------------------------------------------

// q rows per inner tile: 32 at D = 128 keeps the two fp32 [16 x D]
// accumulators (dK, dV) and the two [16 x tile] score tiles within the
// register file; 64 at D = 64.
template <int D>
__host__ __device__ constexpr int dkv_tile() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBlockM + 2 * dkv_tile<D>()) * (D + 8) * 2
         + 3 * dkv_tile<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ di,
                  const int* __restrict__ q_seg,
                  const int* __restrict__ kv_seg,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Lq,
                  int S, float sm_scale, int causal, int q_offset) {
  constexpr int LD = D + 8;
  constexpr int BN = dkv_tile<D>();
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBlockM * LD;
  __nv_bfloat16* sQ = sV + kBlockM * LD;
  __nv_bfloat16* sdO = sQ + BN * LD;
  float* sLse = reinterpret_cast<float*>(sdO + BN * LD);
  float* sDi = sLse + BN;
  int* sSeg = reinterpret_cast<int*>(sDi + BN);

  const int k0 = blockIdx.x * kBlockM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = (long)b * S * kv_stride + (long)hk * D;
  load_tile<D, kBlockM>(sK, k + kv_off, kv_stride, k0, S, tid);
  load_tile<D, kBlockM>(sV, v + kv_off, kv_stride, k0, S, tid);

  // The two kv rows this thread owns in the accumulator layout.
  const int wrow = warp * 16;
  const int kr0 = k0 + wrow + g;
  const int kr1 = kr0 + 8;
  const int kseg0 = kr0 < S ? kv_seg[(long)b * S + kr0] : 0;
  const int kseg1 = kr1 < S ? kv_seg[(long)b * S + kr1] : 0;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }

  const int n_q_tiles = (Lq + BN - 1) / BN;
  // First q tile whose last row can see kv row k0 (causal): q_offset +
  // q0 + BN - 1 >= k0.
  const int first = causal ? max(k0 - q_offset, 0) / BN : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const long q_off = (long)b * Lq * q_stride + (long)h * D;
    const long row_base = ((long)b * H + h) * Lq;
    for (int i = first; i < n_q_tiles; ++i) {
      const int q0 = i * BN;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<D, BN>(sQ, q + q_off, q_stride, q0, Lq, tid);
      load_tile<D, BN>(sdO, dout + q_off, q_stride, q0, Lq, tid);
      if (tid < BN) {
        const int r = q0 + tid;
        sSeg[tid] = r < Lq ? q_seg[(long)b * Lq + r] : 0;
        sLse[tid] = r < Lq ? lse[row_base + r] : 0.f;
        sDi[tid] = r < Lq ? di[row_base + r] : 0.f;
      }
      __syncthreads();

      // P^T = where(mask, exp(S^T scale - LSE), 0): rows kv, columns q.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      gemm_abt<D, NT>(s, sK, wrow, sQ, g, t4);  // S^T = K Q^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + t4 * 2 + e;
          const int qseg = sSeg[col];
          const int qpos = q_offset + q0 + col;
          const float l = sLse[col];
          const bool ok0 = kseg0 != 0 && qseg == kseg0 && (!causal || qpos >= kr0);
          const bool ok1 = kseg1 != 0 && qseg == kseg1 && (!causal || qpos >= kr1);
          s[nt][e] = ok0 ? expf(s[nt][e] * sm_scale - l) : 0.f;
          s[nt][2 + e] = ok1 ? expf(s[nt][2 + e] * sm_scale - l) : 0.f;
        }
      }
      gemm_pb<D, NT>(dv_acc, s, sdO, g, t4);  // dV += P^T dO (P in bf16)

      float dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      gemm_abt<D, NT>(dp, sV, wrow, sdO, g, t4);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = sDi[nt * 8 + t4 * 2 + e];
          dp[nt][e] = s[nt][e] * (dp[nt][e] - d) * sm_scale;
          dp[nt][2 + e] = s[nt][2 + e] * (dp[nt][2 + e] - d) * sm_scale;
        }
      }
      gemm_pb<D, NT>(dk_acc, dp, sQ, g, t4);  // dK += dS^T Q (dS in bf16)
    }
  }

  store_rows<D>(dk + kv_off, kv_stride, kr0, kr1, S, dk_acc, t4);
  store_rows<D>(dv + kv_off, kv_stride, kr0, kr1, S, dv_acc, t4);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *di, *q_seg, *kv_seg;
  int B, H, Hkv, Lq, S;
  float sm_scale;
  int causal, q_offset;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kBlockM - 1) / kBlockM, a.H, a.B);
  fa_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<const int*>(a.q_seg), static_cast<const int*>(a.kv_seg),
      static_cast<__nv_bfloat16*>(dq), a.H, a.Hkv, a.Lq, a.S, a.sm_scale,
      a.causal, a.q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kBlockM - 1) / kBlockM, a.Hkv, a.B);
  fa_bwd_dkv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<const int*>(a.q_seg), static_cast<const int*>(a.kv_seg),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.H,
      a.Hkv, a.Lq, a.S, a.sm_scale, a.causal, a.q_offset);
  return cudaGetLastError();
}

bool valid(int B, int H, int Hkv, int Lq, int S) {
  return B > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && Lq > 0 && S > 0 &&
         B <= 65535 && H <= 65535;
}

}  // namespace

extern "C" int mc_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* q_seg, const void* kv_seg,
    void* dq, int B, int H, int Hkv, int Lq, int S, int D, float sm_scale,
    int causal, int q_offset, void* stream) {
  if (!valid(B, H, Hkv, Lq, S)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, di, q_seg, kv_seg, B, H, Hkv, Lq, S,
               sm_scale, causal, q_offset, static_cast<cudaStream_t>(stream)};
  if (D == 128) return launch_dq<128>(a, dq);
  if (D == 64) return launch_dq<64>(a, dq);
  return cudaErrorInvalidValue;
}

extern "C" int mc_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* q_seg, const void* kv_seg,
    void* dk, void* dv, int B, int H, int Hkv, int Lq, int S, int D,
    float sm_scale, int causal, int q_offset, void* stream) {
  if (!valid(B, H, Hkv, Lq, S)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, di, q_seg, kv_seg, B, H, Hkv, Lq, S,
               sm_scale, causal, q_offset, static_cast<cudaStream_t>(stream)};
  if (D == 128) return launch_dkv<128>(a, dk, dv);
  if (D == 64) return launch_dkv<64>(a, dk, dv);
  return cudaErrorInvalidValue;
}
