// The decode layer's elementwise passes for Hopper, sm_90a (kernels K8, K9
// and K10), each in one launch:
//   K8  add_rms_norm_kernel   s = T(x + y), out = T(w * T(s * rsqrt(mean(s^2)
//                             + eps))): the residual add and Llama's RMSNorm
//                             (or the norm alone, with no y);
//   K9  rope_kv_write_kernel  q and k rotated (rotate-half RoPE), the rotated
//                             q returned, k and v written at the token's
//                             slot of the layer-stacked KV cache: int8 with
//                             a per-vector scale, or T;
//   K10 silu_mul_kernel       out = T(T(silu(gate)) * up).
// T is bf16 or fp16 (the activations' type); every product and sum is in
// fp32, rounded to T where the plain PyTorch version rounds.
//
// Replace no Pallas kernel.  They are the counterparts of the fusions XLA
// makes of the JAX decode step's elementwise work, one jitted program
// (modelcompose_tpu/core/generate.py `_decode_step`; the layer at
// core/llama.py:362-376): RMSNorm (ops/norms.py:9), RoPE (ops/rope.py:36),
// the int8 KV quantize and the scatter (core/llama.py:192, :259-269), the
// SiLU product (:323) and the residual adds.  The port's plain route
// (modelcompose_tpu_torch/ops/decode_fused.py, the composition of the port's
// ops) launches each PyTorch op as its own kernel: ~40 small launches a
// layer at one row, about half of a replayed decode step's device time.
//
// What bounds them on the H100: device memory, and at one row the launch
// itself.  A decode step's rows are few (1-8), so each pass moves a few
// kilobytes to ~180 KB; the card's fixed cost of a kernel (a few
// microseconds) dwarfs the bytes.  The design is one launch for each group
// of ops that share their data, every input read once and every output
// written once:
//   - K8: one block of 256 threads a row, each thread holding up to four
//     16-byte vectors of the row in registers (H <= 8,192); the sum of
//     squares by warp shuffles and a shared-memory step over the 8 warps,
//     then `rsqrtf` (the function PyTorch's CUDA `rsqrt` calls), and the
//     normed row written from the registers.  The sum's order is not
//     PyTorch's reduction order, so the normed value may differ from the
//     plain version's by one unit in the last place of T; x + y is
//     bit-equal.  The arithmetic lives in decode_norm.cuh, shared with
//     the norm prologue of K5's streaming kernel (w8a16_gemv.cu), which
//     takes K8's place at 1-2 rows where a grouped int8 product reads the
//     norm's output; this launch stays for the final norm and 3-8 rows.
//   - K9: one warp a head vector (q's heads, then k's, then v's of a row;
//     four warps a block), lane l holding elements [E l, E l + E) of each
//     half (E = D / 64), so a rotate-half partner is in the same lane.  The
//     rotation is `__fmul_rn` / `__fadd_rn` (three separately rounded
//     operations, as the plain version's three PyTorch kernels compute
//     them; nvcc would contract `a * b + c` into an FMA), rounded to T.  The
//     int8 quantize is the plain version's on the card, op for op: amax by
//     warp shuffles, scale = max(amax * (1 / 127), 1e-8) (PyTorch's CUDA
//     division by a Python scalar multiplies by the fp32 reciprocal),
//     rintf(v / scale) (an IEEE division; round half to even) clamped to
//     [-127, 127].  The slot position is read from device memory inside the
//     kernel, so a captured decode graph replays with each step's position.
//     At 1-2 rows with no adapter branch the epilogue of K5's q/k/v launch
//     does this work instead (w8a16_gemv.cu); this launch stays for 3-8
//     rows and the adapter-branch decode.
//   - K10: a flat grid over 16-byte vectors of gate and up (8 elements a
//     thread); silu as ATen computes it, x / (1 + expf(-x)) in fp32 (the
//     build uses no fast math), rounded to T before the product.  The
//     arithmetic lives in decode_silu.cuh, shared with the SiLU prologue of
//     K5's streaming kernel, which takes K10's place at 1-2 rows (the down
//     product reads h = silu(gate) * up as it streams); this launch stays
//     for 3-8 rows.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "decode_norm.cuh"
#include "decode_silu.cuh"

namespace {

// ------------------------------------------------------------------ helpers

using decode_norm::from_f;
using decode_norm::half_at;
using decode_norm::pack2;
using decode_norm::round_t;
using decode_norm::to_f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------------ K8

constexpr int kNormThreads = decode_norm::kThreads;
constexpr int kNormVecs = decode_norm::kVecs;  // 16-byte vectors a thread
constexpr int kNormMaxH = decode_norm::kMaxH;  // 8,192

// Row blockIdx.x of x [M, H] (and y): thread t takes the row's 16-byte
// vectors t, t + 256, ...; with kAdd the rounded sum s = T(x + y) is
// written to `sum`, else s = x.  out = T(w * T(s * r)), r = rsqrt(sum of s^2
// / H + eps).  The arithmetic is decode_norm.cuh's, which K5's norm
// prologue shares.
template <typename T, bool kAdd>
__global__ void __launch_bounds__(kNormThreads)
add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ w, T* __restrict__ sum,
                    T* __restrict__ out, int H, float eps) {
  __shared__ float warp_sums[kNormThreads / 32];
  const int nv = H / 8;
  const long base = static_cast<long>(blockIdx.x) * nv;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + base;
  uint4 s[kNormVecs];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kNormVecs; ++u) {
    const int v = threadIdx.x + u * kNormThreads;
    if (v >= nv) break;
    s[u] = xr[v];
    if constexpr (kAdd) {
      s[u] = decode_norm::add8<T>(
          s[u], (reinterpret_cast<const uint4*>(y) + base)[v]);
      (reinterpret_cast<uint4*>(sum) + base)[v] = s[u];
    }
    ss = decode_norm::sum_squares8<T>(s[u], ss);
  }
  ss = decode_norm::warp_sum(ss);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
  __syncthreads();
  const float r = decode_norm::rms_rsqrt(warp_sums, H, eps);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(out) + base;
#pragma unroll
  for (int u = 0; u < kNormVecs; ++u) {
    const int v = threadIdx.x + u * kNormThreads;
    if (v >= nv) break;
    orow[v] = decode_norm::norm8<T>(s[u], __ldg(wr + v), r);
  }
}

template <typename T>
int norm_launch(const void* x, const void* y, const void* w, void* sum,
                void* out, int M, int H, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (y != nullptr)
    add_rms_norm_kernel<T, true><<<M, kNormThreads, 0, st>>>(
        xt, static_cast<const T*>(y), wt, static_cast<T*>(sum), ot, H, eps);
  else
    add_rms_norm_kernel<T, false><<<M, kNormThreads, 0, st>>>(
        xt, nullptr, wt, nullptr, ot, H, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K9

constexpr int kRopeWarps = 4;  // head vectors a block

// Head vector h of row blockIdx.y, over q's H heads, then k's Hkv, then
// v's Hkv (warp h % 4 of block h / 4).  Lane l holds elements j = E l + e
// and j + D / 2 (E = D / 64).  q and k are rotated and rounded to T; q goes
// to q_out [B, H, D]; k and v to the cache at [layer, b, pos[b], head]:
// kInt8, the int8 values [.., D] and the fp32 scale [.., 1]; else T.
template <typename T, int D, bool kInt8>
__global__ void __launch_bounds__(kRopeWarps * 32)
rope_kv_write_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ cosv,
                     const float* __restrict__ sinv, T* __restrict__ q_out,
                     void* __restrict__ cache_k, void* __restrict__ cache_v,
                     float* __restrict__ scale_k,
                     float* __restrict__ scale_v, const void* __restrict__ pos,
                     int pos64, int B, int S, int H, int Hkv, int layer) {
  constexpr int E = D / 64;
  constexpr int kHalf = D / 2;
  const int b = blockIdx.y;
  const int head = blockIdx.x * kRopeWarps + threadIdx.x / 32;
  if (head >= H + 2 * Hkv) return;  // a whole warp leaves together
  const int lane = threadIdx.x % 32;
  const int j0 = lane * E;
  const T* src;
  int kind, hh;  // 0 q, 1 k, 2 v; the head within its tensor
  if (head < H) {
    kind = 0, hh = head, src = q + (static_cast<long>(b) * H + hh) * D;
  } else if (head < H + Hkv) {
    kind = 1, hh = head - H, src = k + (static_cast<long>(b) * Hkv + hh) * D;
  } else {
    kind = 2, hh = head - H - Hkv;
    src = v + (static_cast<long>(b) * Hkv + hh) * D;
  }
  float lo[E], hi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    lo[e] = to_f<T>(src[j0 + e]);
    hi[e] = to_f<T>(src[j0 + e + kHalf]);
  }
  if (kind != 2) {
    // q * cos + rotate_half(q) * sin, rotate_half(q) = [-q2, q1]
    const float* c = cosv + static_cast<long>(b) * D;
    const float* s = sinv + static_cast<long>(b) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = j0 + e;
      const float r_lo = __fadd_rn(__fmul_rn(lo[e], __ldg(c + j)),
                                   __fmul_rn(-hi[e], __ldg(s + j)));
      const float r_hi = __fadd_rn(__fmul_rn(hi[e], __ldg(c + j + kHalf)),
                                   __fmul_rn(lo[e], __ldg(s + j + kHalf)));
      lo[e] = round_t<T>(r_lo);
      hi[e] = round_t<T>(r_hi);
    }
  }
  if (kind == 0) {
    T* dst = q_out + (static_cast<long>(b) * H + hh) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dst[j0 + e] = from_f<T>(lo[e]);
      dst[j0 + e + kHalf] = from_f<T>(hi[e]);
    }
    return;
  }
  const long p = pos64 ? static_cast<const long long*>(pos)[b]
                       : static_cast<const int*>(pos)[b];
  if (p < 0 || p >= S) return;  // no slot: the wrapper's positions are < S
  const long slot = ((static_cast<long>(layer) * B + b) * S + p) * Hkv + hh;
  void* cache = kind == 1 ? cache_k : cache_v;
  if constexpr (kInt8) {
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fmaxf(fabsf(lo[e]),
                                                         fabsf(hi[e])));
    amax = warp_max(amax);
    // clamp_min(amax / 127.0, 1e-8): the scalar's fp32 reciprocal, then
    // the clamp at 1e-8 as fp32
    const float scale = fmaxf(__fmul_rn(amax, 1.0f / 127.0f),
                              static_cast<float>(1e-8));
    int8_t* dst = static_cast<int8_t*>(cache) + slot * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dst[j0 + e] = static_cast<int8_t>(
          fminf(fmaxf(rintf(lo[e] / scale), -127.f), 127.f));
      dst[j0 + e + kHalf] = static_cast<int8_t>(
          fminf(fmaxf(rintf(hi[e] / scale), -127.f), 127.f));
    }
    if (lane == 0) (kind == 1 ? scale_k : scale_v)[slot] = scale;
  } else {
    T* dst = static_cast<T*>(cache) + slot * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dst[j0 + e] = from_f<T>(lo[e]);
      dst[j0 + e + kHalf] = from_f<T>(hi[e]);
    }
  }
}

template <typename T, int D>
int rope_launch(const void* q, const void* k, const void* v, const void* c,
                const void* s, void* q_out, void* ck, void* cv, void* sk,
                void* sv, const void* pos, int pos64, int B, int S, int H,
                int Hkv, int layer, int int8, cudaStream_t st) {
  const dim3 grid((H + 2 * Hkv + kRopeWarps - 1) / kRopeWarps, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* ct = static_cast<const float*>(c);
  const float* st_ = static_cast<const float*>(s);
  if (int8)
    rope_kv_write_kernel<T, D, true><<<grid, kRopeWarps * 32, 0, st>>>(
        qt, kt, vt, ct, st_, static_cast<T*>(q_out), ck, cv,
        static_cast<float*>(sk), static_cast<float*>(sv), pos, pos64, B, S,
        H, Hkv, layer);
  else
    rope_kv_write_kernel<T, D, false><<<grid, kRopeWarps * 32, 0, st>>>(
        qt, kt, vt, ct, st_, static_cast<T*>(q_out), ck, cv, nullptr,
        nullptr, pos, pos64, B, S, H, Hkv, layer);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K10

constexpr int kSiluThreads = 256;

// out = T(T(silu(gate)) * up) over `vectors` 16-byte vectors (8 elements).
template <typename T>
__global__ void __launch_bounds__(kSiluThreads)
silu_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                T* __restrict__ out, long vectors) {
  const long v = static_cast<long>(blockIdx.x) * kSiluThreads + threadIdx.x;
  if (v >= vectors) return;
  const uint4 g = reinterpret_cast<const uint4*>(gate)[v];
  const uint4 u = reinterpret_cast<const uint4*>(up)[v];
  const uint32_t g4[4] = {g.x, g.y, g.z, g.w};
  const uint32_t u4[4] = {u.x, u.y, u.z, u.w};
  uint32_t o4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float r[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      r[p] = decode_silu::silu_mul<T>(half_at<T>(g4[e], p),
                                      half_at<T>(u4[e], p));
    }
    o4[e] = pack2<T>(r[0], r[1]);
  }
  reinterpret_cast<uint4*>(out)[v] = make_uint4(o4[0], o4[1], o4[2], o4[3]);
}

}  // namespace

// K8 on x [M, H] (and y [M, H], or null): sum = T(x + y) where y is given,
// out = the RMSNorm of the sum (or of x) times w [H].  T is bf16 (x_bf16)
// or fp16.  Returns cudaErrorInvalidValue, launching nothing, for M < 1,
// H % 8, H > 8,192 or a pointer that is not 16-byte aligned.
extern "C" int mc_add_rms_norm(const void* x, const void* y, const void* w,
                               void* sum, void* out, int M, int H, float eps,
                               int x_bf16, void* stream) {
  if (M < 1 || H < 8 || H % 8 || H > kNormMaxH || !aligned16(x) ||
      !aligned16(w) || !aligned16(out) ||
      (y != nullptr && (!aligned16(y) || !aligned16(sum))))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? norm_launch<__nv_bfloat16>(x, y, w, sum, out, M, H, eps, st)
                : norm_launch<__half>(x, y, w, sum, out, M, H, eps, st);
}

// K9 on q [B, H, D], k and v [B, Hkv, D] (one token a row), cos and sin
// [B, D] fp32: q_out [B, H, D] the rotated q; the rotated k and v written
// at [layer, b, pos[b]] of the caches [NL, B, S, Hkv, D] (int8 with fp32
// scales [NL, B, S, Hkv, 1] where int8, else T).  pos is int64 (pos64) or
// int32, on the device.  Returns cudaErrorInvalidValue, launching nothing,
// for D other than 64 or 128, B, H or Hkv < 1, S < 1 or a layer < 0.
extern "C" int mc_rope_kv_write(const void* q, const void* k, const void* v,
                                const void* cos, const void* sin, void* q_out,
                                void* cache_k, void* cache_v, void* scale_k,
                                void* scale_v, const void* pos, int pos64,
                                int B, int S, int H, int Hkv, int D,
                                int layer, int int8, int x_bf16,
                                void* stream) {
  if ((D != 64 && D != 128) || B < 1 || S < 1 || H < 1 || Hkv < 1 ||
      layer < 0 || (int8 && (scale_k == nullptr || scale_v == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return D == 128
               ? rope_launch<__nv_bfloat16, 128>(
                     q, k, v, cos, sin, q_out, cache_k, cache_v, scale_k,
                     scale_v, pos, pos64, B, S, H, Hkv, layer, int8, st)
               : rope_launch<__nv_bfloat16, 64>(
                     q, k, v, cos, sin, q_out, cache_k, cache_v, scale_k,
                     scale_v, pos, pos64, B, S, H, Hkv, layer, int8, st);
  return D == 128 ? rope_launch<__half, 128>(q, k, v, cos, sin, q_out,
                                             cache_k, cache_v, scale_k,
                                             scale_v, pos, pos64, B, S, H,
                                             Hkv, layer, int8, st)
                  : rope_launch<__half, 64>(q, k, v, cos, sin, q_out,
                                            cache_k, cache_v, scale_k,
                                            scale_v, pos, pos64, B, S, H, Hkv,
                                            layer, int8, st);
}

// K10 on gate and up [n] (n % 8 == 0, 16-byte aligned): out = T(T(silu(
// gate)) * up).  Returns cudaErrorInvalidValue, launching nothing,
// otherwise.
extern "C" int mc_silu_mul(const void* gate, const void* up, void* out,
                           long long n, int x_bf16, void* stream) {
  if (n < 8 || n % 8 || !aligned16(gate) || !aligned16(up) || !aligned16(out))
    return cudaErrorInvalidValue;
  const long vectors = static_cast<long>(n / 8);
  const unsigned blocks =
      static_cast<unsigned>((vectors + kSiluThreads - 1) / kSiluThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    silu_mul_kernel<__nv_bfloat16><<<blocks, kSiluThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gate),
        static_cast<const __nv_bfloat16*>(up),
        static_cast<__nv_bfloat16*>(out), vectors);
  else
    silu_mul_kernel<__half><<<blocks, kSiluThreads, 0, st>>>(
        static_cast<const __half*>(gate), static_cast<const __half*>(up),
        static_cast<__half*>(out), vectors);
  return cudaGetLastError();
}
