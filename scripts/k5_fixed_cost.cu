// The fixed cost of a one-row K5 launch taken apart, on the first version
// of the one-row kernel (the scalar loop of modelcompose_tpu_torch/csrc/
// w8a16_gemv.cu up to its streaming redesign), for
// scripts/torch_kernel_ab.py --only K5.  Each probe runs on that kernel's
// grid (`_row_plan`: 512-column tiles, K split into runs of at most 512
// rows, about 264 blocks), so the differences between probes are what each
// part of the launch costs:
//   0  the kernel as it was: x staged in shared memory behind a barrier
//      before the first weight load, the stream, the 8 warps' sums through
//      16 KB of shared memory, the split partials, a fence, the counter, and
//      the last block of a tile reading every split's partial, 8 loads in
//      flight a thread;
//   1  the same with x staging skipped (every x taken as 1.0: no read of x,
//      no barrier before the stream);
//   2  the same with the combine skipped (each block writes its partial and
//      ends: no fence, counter or last block);
//   3  both skipped: the stream and the warps' sums alone;
//   4  an empty kernel on the same grid and block size.
// Only probe 0 computes the product; the others are for timing.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I modelcompose_tpu_torch/csrc \
//        -o k5_fixed_cost.so scripts/k5_fixed_cost.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowCols = 16;             // int8 columns a thread
constexpr int kRowTile = 32 * kRowCols;  // 512 columns a block
constexpr int kRowMaxRows = 512;         // K rows a block
constexpr int kRowUnroll = 8;            // row loads a warp keeps in flight
constexpr int kRowThreads = kWarps * 32;

template <bool kStageX, bool kCombine>
__global__ void __launch_bounds__(kRowThreads)
one_row_probe(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ q, const float* __restrict__ scale,
              float* __restrict__ part, unsigned* __restrict__ counters,
              float* __restrict__ out, int K, int N, int rows) {
  __shared__ __align__(16) float sX[kRowMaxRows];
  __shared__ __align__(16) float sRed[kWarps * kRowTile];
  __shared__ int sLast;

  const int tile = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = split * rows;
  const int n = min(rows, K - k0);
  const int col = tile * kRowTile + lane * kRowCols;

  if (kStageX) {
    for (int r = tid; r < n; r += kRowThreads)
      sX[r] = __bfloat162float(x[k0 + r]);
    __syncthreads();
  }

  float acc[kRowCols];
#pragma unroll
  for (int c = 0; c < kRowCols; ++c) acc[c] = 0.f;
  if (col < N) {
    const int8_t* qp = q + (long)k0 * N + col;
    for (int r0 = warp; r0 < n; r0 += kWarps * kRowUnroll) {
      uint4 w[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int r = r0 + u * kWarps;
        w[u] = r < n ? __ldcs(reinterpret_cast<const uint4*>(qp + (long)r * N))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int r = r0 + u * kWarps;
        if (r < n) {
          const float xr = kStageX ? sX[r] : 1.f;
          float wf[kRowCols];
          hopper::cvt4(w[u].x, wf);
          hopper::cvt4(w[u].y, wf + 4);
          hopper::cvt4(w[u].z, wf + 8);
          hopper::cvt4(w[u].w, wf + 12);
#pragma unroll
          for (int c = 0; c < kRowCols; ++c) acc[c] = fmaf(xr, wf[c], acc[c]);
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kRowCols; c += 4)
    *reinterpret_cast<float4*>(sRed + warp * kRowTile + lane * kRowCols + c) =
        make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  __syncthreads();
  const int c2 = 2 * tid;
  const int n_col = tile * kRowTile + c2;
  float2 sc = make_float2(0.f, 0.f);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float2 t = *reinterpret_cast<const float2*>(sRed + w * kRowTile + c2);
    s0 += t.x;
    s1 += t.y;
  }
  if (n_col < N) {
    sc = *reinterpret_cast<const float2*>(scale + n_col);
    if (n_splits == 1)
      *reinterpret_cast<float2*>(out + n_col) = make_float2(s0 * sc.x, s1 * sc.y);
    else
      *reinterpret_cast<float2*>(part + (long)split * N + n_col) =
          make_float2(s0, s1);
  }
  if (n_splits == 1 || !kCombine) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned done = atomicAdd(&counters[tile], 1u);
    sLast = done == static_cast<unsigned>(n_splits - 1);
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  if (n_col < N) {
    float t0 = 0.f, t1 = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s) {
      const float2 v =
          __ldcg(reinterpret_cast<const float2*>(part + (long)s * N + n_col));
      t0 += v.x;
      t1 += v.y;
    }
    *reinterpret_cast<float2*>(out + n_col) = make_float2(t0 * sc.x, t1 * sc.y);
  }
  if (tid == 0) counters[tile] = 0;
}

__global__ void __launch_bounds__(kRowThreads) empty_probe() {}

}  // namespace

// Probe `kind` (0-4 above) of one-row x [K] bf16 times q [K, N] int8 with an
// fp32 result, at `rows` K rows a block (probes 0-3: a multiple of 64, at
// most 512; the empty kernel takes any, for another kernel's grid).
extern "C" int k5_probe(int kind, const void* x, const void* q,
                        const void* scale, void* part, void* counters,
                        void* out, int K, int N, int rows, void* stream) {
  if (kind < 0 || kind > 4 || K <= 0 || N <= 0 || N % 16 != 0 || rows <= 0 ||
      (kind < 4 && (rows % 64 != 0 || rows > kRowMaxRows)))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kRowTile - 1) / kRowTile, (K + rows - 1) / rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(scale);
  auto* pb = static_cast<float*>(part);
  auto* cb = static_cast<unsigned*>(counters);
  auto* ob = static_cast<float*>(out);
  switch (kind) {
    case 0:
      one_row_probe<true, true><<<grid, kRowThreads, 0, st>>>(
          xb, qb, sb, pb, cb, ob, K, N, rows);
      break;
    case 1:
      one_row_probe<false, true><<<grid, kRowThreads, 0, st>>>(
          xb, qb, sb, pb, cb, ob, K, N, rows);
      break;
    case 2:
      one_row_probe<true, false><<<grid, kRowThreads, 0, st>>>(
          xb, qb, sb, pb, cb, ob, K, N, rows);
      break;
    case 3:
      one_row_probe<false, false><<<grid, kRowThreads, 0, st>>>(
          xb, qb, sb, pb, cb, ob, K, N, rows);
      break;
    default:
      empty_probe<<<grid, kRowThreads, 0, st>>>();
  }
  return cudaGetLastError();
}
