// The decode layer's SiLU product, one element at a time, shared by kernel
// K10 (decode_fused.cu `silu_mul_kernel`) and by the SiLU prologue of K5's
// streaming kernel (w8a16_gemv.cu), so that the two compute the same bits.
// T is bf16 or fp16 (the activations' type); silu is computed as ATen
// computes it, g / (1 + expf(-g)) in fp32 (the build uses no fast math),
// rounded to T before the product with up, as the plain PyTorch version
// (``F.silu(gate) * up`` on T tensors) rounds it.
#pragma once

#include "decode_norm.cuh"

namespace decode_silu {

// T(silu(g)) * u in fp32, not yet rounded to T: the caller rounds it
// (packed by K10, or as the element of h the prologue multiplies).
template <typename T>
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float silu = decode_norm::round_t<T>(g / (1.0f + expf(-g)));
  return __fmul_rn(silu, u);
}

// T(T(silu(g)) * u) of one element whose bits lie in v: g in the low half,
// u in the high half.
template <typename T>
__device__ __forceinline__ float silu_mul_at(uint32_t v) {
  return decode_norm::round_t<T>(silu_mul<T>(
      decode_norm::half_at<T>(v, 0), decode_norm::half_at<T>(v, 1)));
}

}  // namespace decode_silu
