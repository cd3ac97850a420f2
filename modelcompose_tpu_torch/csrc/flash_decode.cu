// Flash-decode (kernel K2) for Hopper, sm_90a: one-token attention per
// batch row over one layer of the layer-stacked KV cache.
//
// Replaces the Pallas TPU kernel modelcompose_tpu/ops/flash_decode.py
// `_fd_kernel` (driven by `flash_decode_attention`); its semantics are
// those of the XLA loop modelcompose_tpu/ops/attention.py
// `decode_attention`:
//     logits = (q * scale) . k  [* k_scale]   masked to pos < kv_len[b]
//     out    = sum softmax(logits) [* v_scale] v
// with the int8 cache's per-vector scales factored out of both
// contractions, so the int8 bytes are what stream from memory.
//
// What bounds it on the H100: device-memory bytes.  A decode step reads
// this layer's whole valid cache once (int8: 2 * kv_len * Hkv * D bytes
// per row) and does only ~2 flops per byte.  The design is split-KV
// flash-decoding: pass 1 has one block per (split of 256 positions, kv
// head, batch row), so even a batch of 1-2 rows puts hundreds of blocks
// on the 132 SMs; each block streams its split once with 8- or 16-byte
// loads (a team of D/8 lanes per position), serves all `group` q heads of
// its kv head from that one read (GQA), and writes partial (m, l, acc).
// Splits past kv_len exit at once.  Pass 2 combines the splits.
// `layer` is an offset into the stacked cache, so no per-layer slice is
// ever materialized, and any S is taken (the TPU kernel needed a multiple
// of 128).
//
// Layouts: q [B, H, D] bf16; caches [NL, B, S, Hkv, D] bf16, or int8 with
// fp32 scales [NL, B, S, Hkv] (the trailing 1 of [..., Hkv, 1] dropped);
// kv_len [B] int32; partials m, l [B, H, n_splits] and acc
// [B, H, n_splits, D] fp32; out [B, H, D] bf16.  D in {64, 128}; the GQA
// group H / Hkv in {1, 2, 4, 8}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 256;  // cache positions per pass-1 block
constexpr float kNegInf = -1e30f;

// Eight consecutive cache elements as fp32.
__device__ __forceinline__ void load8(const int8_t* p, float f[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = static_cast<float>(c[e]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* c = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(c[e]);
}

template <int D, int G, typename T>
__global__ void __launch_bounds__(kThreads)
fd_split_kernel(const __nv_bfloat16* __restrict__ q,
                const T* __restrict__ kc, const T* __restrict__ vc,
                const float* __restrict__ ks, const float* __restrict__ vs,
                const int* __restrict__ kv_len, float* __restrict__ part_m,
                float* __restrict__ part_l, float* __restrict__ part_acc,
                int B, int H, int Hkv, int S, int n_splits, int layer,
                float sm_scale) {
  constexpr int kLanes = D / 8;             // lanes per cache position
  constexpr int kTeams = kThreads / kLanes;  // positions in flight
  __shared__ float sP[G][kSplit];
  __shared__ float sAcc[kTeams][G * D];
  __shared__ float sM[G], sL[G];

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = min(kv_len[b], S);
  const int s0 = sp * kSplit;
  const int s1 = min(s0 + kSplit, len);
  if (s0 >= s1) return;  // past kv_len: the combine pass skips this split
  const int n = s1 - s0;

  const int tid = threadIdx.x;
  const int team = tid / kLanes;
  const int tl = tid % kLanes;
  const int warp = tid >> 5, lane = tid & 31;

  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qp = q + ((long)b * H + hk * G + g) * D + tl * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[g][e] = __bfloat162float(qp[e]) * sm_scale;
  }

  // Cache vector (layer, b, pos, hk) lives at index ((layer*B+b)*S+pos)*Hkv+hk.
  const long row0 = ((long)layer * B + b) * S;

  // Phase 1: logits of this split, one team of lanes per position.  The
  // loop bound is uniform over the block so every lane of a warp reaches
  // the shuffles; a team past the split's end computes on zeros.
  for (int p0 = s0; p0 < s1; p0 += kTeams) {
    const int p = p0 + team;
    const long vec = (row0 + p) * Hkv + hk;
    float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (p < s1) load8(kc + vec * D + tl * 8, kf);
    float dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += qr[g][e] * kf[e];
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      dot[g] = acc;
    }
    if (tl == 0 && p < s1) {
      const float scale = ks ? ks[vec] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) sP[g][p - s0] = dot[g] * scale;
    }
  }
  __syncthreads();

  // Phase 2: per-head max and sum over the split; sP becomes exp(s - m).
  for (int g = warp; g < G; g += kThreads / 32) {
    float m = kNegInf;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sP[g][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sP[g][i] - m);
      sP[g][i] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      sM[g] = m;
      sL[g] = l;
    }
  }
  __syncthreads();

  // Phase 3: acc = sum_p p [* v_scale] v, per team, then across teams.
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int p = s0 + team; p < s1; p += kTeams) {
    const long vec = (row0 + p) * Hkv + hk;
    float vf[8];
    load8(vc + vec * D + tl * 8, vf);
    const float scale = vs ? vs[vec] : 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float w = sP[g][p - s0] * scale;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += w * vf[e];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) sAcc[team][g * D + tl * 8 + e] = acc[g][e];
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kTeams; ++t) sum += sAcc[t][i];
    const int g = i / D, d = i % D;
    const long slot = ((long)b * H + hk * G + g) * n_splits + sp;
    part_acc[slot * D + d] = sum;
  }
  if (tid < G) {
    const long slot = ((long)b * H + hk * G + tid) * n_splits + sp;
    part_m[slot] = sM[tid];
    part_l[slot] = sL[tid];
  }
}

// Pass 2: one block per (head, batch row), one thread per output element.
__global__ void fd_combine_kernel(const float* __restrict__ part_m,
                                  const float* __restrict__ part_l,
                                  const float* __restrict__ part_acc,
                                  const int* __restrict__ kv_len,
                                  __nv_bfloat16* __restrict__ out, int H,
                                  int S, int D, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(kv_len[b], S);
  const int n_valid = (len + kSplit - 1) / kSplit;
  const long base = ((long)b * H + h) * n_splits;
  float m = -INFINITY;
  for (int s = 0; s < n_valid; ++s) m = fmaxf(m, part_m[base + s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_valid; ++s) {
    const float w = expf(part_m[base + s] - m);
    l += w * part_l[base + s];
    acc += w * part_acc[(base + s) * D + d];
  }
  out[((long)b * H + h) * D + d] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

template <int D, int G, typename T>
cudaError_t launch_split(const void* q, const void* kc, const void* vc,
                         const void* ks, const void* vs, const void* kv_len,
                         void* part_m, void* part_l, void* part_acc, int B,
                         int H, int Hkv, int S, int n_splits, int layer,
                         float sm_scale, cudaStream_t stream) {
  dim3 grid(n_splits, Hkv, B);
  fd_split_kernel<D, G, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_len),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), B, H, Hkv, S, n_splits, layer,
      sm_scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dispatch_group(int G, const void* q, const void* kc,
                           const void* vc, const void* ks, const void* vs,
                           const void* kv_len, void* pm, void* pl, void* pa,
                           int B, int H, int Hkv, int S, int n_splits,
                           int layer, float sm_scale, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch_split<D, 1, T>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, B,
                                   H, Hkv, S, n_splits, layer, sm_scale, st);
    case 2:
      return launch_split<D, 2, T>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, B,
                                   H, Hkv, S, n_splits, layer, sm_scale, st);
    case 4:
      return launch_split<D, 4, T>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, B,
                                   H, Hkv, S, n_splits, layer, sm_scale, st);
    case 8:
      return launch_split<D, 8, T>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, B,
                                   H, Hkv, S, n_splits, layer, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mc_flash_decode_split_len(void) { return kSplit; }

extern "C" int mc_flash_decode(const void* q, const void* kc, const void* vc,
                               const void* ks, const void* vs,
                               const void* kv_len, void* part_m,
                               void* part_l, void* part_acc, void* out,
                               int B, int H, int Hkv, int S, int D,
                               int layer, int quantized, float sm_scale,
                               void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 ||
      S <= 0 || layer < 0 || (quantized && (!ks || !vs)))
    return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int n_splits = (S + kSplit - 1) / kSplit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128 && quantized)
    err = dispatch_group<128, int8_t>(G, q, kc, vc, ks, vs, kv_len, part_m,
                                      part_l, part_acc, B, H, Hkv, S,
                                      n_splits, layer, sm_scale, st);
  else if (D == 128)
    err = dispatch_group<128, __nv_bfloat16>(
        G, q, kc, vc, nullptr, nullptr, kv_len, part_m, part_l, part_acc, B,
        H, Hkv, S, n_splits, layer, sm_scale, st);
  else if (D == 64 && quantized)
    err = dispatch_group<64, int8_t>(G, q, kc, vc, ks, vs, kv_len, part_m,
                                     part_l, part_acc, B, H, Hkv, S,
                                     n_splits, layer, sm_scale, st);
  else if (D == 64)
    err = dispatch_group<64, __nv_bfloat16>(
        G, q, kc, vc, nullptr, nullptr, kv_len, part_m, part_l, part_acc, B,
        H, Hkv, S, n_splits, layer, sm_scale, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  fd_combine_kernel<<<dim3(H, B), D, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(kv_len),
      static_cast<__nv_bfloat16*>(out), H, S, D, n_splits);
  return cudaGetLastError();
}
