// The decode layer's RMSNorm arithmetic, shared by kernel K8
// (decode_fused.cu `add_rms_norm_kernel`) and by the norm prologue of K5's
// streaming kernel (w8a16_gemv.cu), so that the two compute the same bits:
// the same 16-byte vectors a thread, the same order of the sum of squares,
// the same roundings.  T is bf16 or fp16 (the activations' type); every
// product and sum is in fp32, rounded to T where the plain PyTorch version
// (ops/norms.rms_norm of x + y) rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace decode_norm {

constexpr int kThreads = 256;  // a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;  // 16-byte vectors a thread: H <= 8,192
constexpr int kMaxH = kThreads * kVecs * 8;

// The low (p = 0) or high (p = 1) half of a word of two T values, as fp32.
template <typename T>
__device__ __forceinline__ float half_at(uint32_t w, int p) {
  const uint16_t h = static_cast<uint16_t>(w >> (16 * p));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  } else {
    return __half2float(__ushort_as_half(h));
  }
}

// Two fp32 values rounded to T and packed (lo in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);
  else
    return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float f) {  // round to nearest even
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(f);
  else
    return __float2half_rn(f);
}

// fp32 rounded to T and back: the value a T tensor holds.
template <typename T>
__device__ __forceinline__ float round_t(float f) {
  return to_f<T>(from_f<T>(f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T(a + b) of the 8 values of two 16-byte vectors.
template <typename T>
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  const uint32_t a4[4] = {a.x, a.y, a.z, a.w};
  const uint32_t b4[4] = {b.x, b.y, b.z, b.w};
  uint32_t r4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    r4[e] = pack2<T>(__fadd_rn(half_at<T>(a4[e], 0), half_at<T>(b4[e], 0)),
                     __fadd_rn(half_at<T>(a4[e], 1), half_at<T>(b4[e], 1)));
  return make_uint4(r4[0], r4[1], r4[2], r4[3]);
}

// ss plus the squares of the 8 values of s, in element order, each as one
// fused multiply-add.
template <typename T>
__device__ __forceinline__ float sum_squares8(uint4 s, float ss) {
  const uint32_t s4[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float f = half_at<T>(s4[e / 2], e % 2);
    ss = __fmaf_rn(f, f, ss);
  }
  return ss;
}

// The row's sum of squares from its 8 warps' sums, in warp order, and
// r = rsqrt(sum / H + eps) as PyTorch computes it: mean = sum * (1 / H),
// then rsqrt(mean + eps) (`rsqrtf`, the function its CUDA rsqrt calls).
__device__ __forceinline__ float rms_rsqrt(const float* warp_sums, int H,
                                           float eps) {
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += warp_sums[i];
  return rsqrtf(__fadd_rn(__fmul_rn(total, 1.0f / H), eps));
}

// T(w * T(s * r)) of the 8 values of s and of the weight w.
template <typename T>
__device__ __forceinline__ uint4 norm8(uint4 s, uint4 w, float r) {
  const uint32_t s4[4] = {s.x, s.y, s.z, s.w};
  const uint32_t w4[4] = {w.x, w.y, w.z, w.w};
  uint32_t o4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float n0 = round_t<T>(__fmul_rn(half_at<T>(s4[e], 0), r));
    const float n1 = round_t<T>(__fmul_rn(half_at<T>(s4[e], 1), r));
    o4[e] = pack2<T>(__fmul_rn(half_at<T>(w4[e], 0), n0),
                     __fmul_rn(half_at<T>(w4[e], 1), n1));
  }
  return make_uint4(o4[0], o4[1], o4[2], o4[3]);
}

// norm8's value of one element: T(w * T(s * r)) with s = T(x + y), or x
// where there is no y; v.x holds the bits of x (low half) and y (high),
// v.y those of w.
template <typename T>
__device__ __forceinline__ float norm_at(uint2 v, bool has_y, float r) {
  float s = half_at<T>(v.x, 0);
  if (has_y) s = round_t<T>(__fadd_rn(s, half_at<T>(v.x, 1)));
  return round_t<T>(
      __fmul_rn(half_at<T>(v.y, 0), round_t<T>(__fmul_rn(s, r))));
}

}  // namespace decode_norm
