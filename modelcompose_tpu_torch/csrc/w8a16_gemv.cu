// W8A16 product (kernel K5) for Hopper, sm_90a: a few rows of bf16 or fp16
// activations times an int8 weight with one fp32 scale per column,
//     y[m, n] = (sum_k float(x[m, k]) * float(q[k, n])) * scale[n]
// accumulated in fp32, written fp32 or in the activations' type.
//
// Replaces no Pallas kernel.  The JAX package's modelcompose_tpu/ops/quant.py
// `dequant_matmul` (lines 33-43) keeps the int8 -> bf16 convert inside the
// contraction, and XLA fuses it into the dot's operand load, so on the TPU
// the int8 tensor is what streams from memory.  PyTorch has no such fusion:
// `q.to(bf16)` and a GEMM write a bf16 copy of the weight and read it back,
// 5 bytes moved a weight where the reference moves 1.  This kernel is that
// fused convert for the decode-time products (M <= 8 rows: batch-1 decode,
// the vision pair, beams, the micro-batching worker, the 8-slot pool):
// q, k, v, o, gate, up and down in every layer, and the lm_head.
//
// What bounds it on the H100: device-memory bytes.  Each weight is one byte
// read once, and does 2 * M flops (M <= 8: at most 16 flops a byte, far
// under the ~295 the tensor cores need a byte), so the least time is the
// weight's bytes over 3.35 TB/s: 5.0 us for a 4096 x 4096 matrix.  The
// design keeps the memory busy and does nothing else:
//   - a thread loads 16 contiguous int8 columns of a row as one 16-byte
//     load; a warp spans a 512-column tile of the row (512 contiguous
//     bytes), and the 8 warps of a block take interleaved rows of the
//     block's K range, each with 8 row loads in flight before it converts
//     any: 32 KB in flight a block;
//   - K is split across blocks (at most 512 rows a block, about two blocks
//     an SM over the whole grid), so even a 4096-column matrix puts ~256
//     blocks on the 132 SMs;
//   - the block's K-chunk of x is staged once in shared memory as fp32
//     ([row][M] padded to a vector width), read back as a broadcast;
//   - the M x 16 fp32 accumulators stay in registers; int8 becomes fp32 by
//     a byte permute and an add (exact, `cvt4`);
//   - the 8 warps' sums meet in shared memory in a fixed order; with K
//     split, each block writes its fp32 partial and bumps a counter of its
//     column tile, and the last block of the tile adds the partials in
//     split order (deterministic: no float atomics) and resets the counter
//     (as K2 combines its splits), so a product is one launch;
//   - the per-column scale and the cast are the epilogue.
// Later work: a TMA + wgmma W8A16 GEMM for large M (prefill, chunks,
// training), which still converts the weight with a copy; `wgmma` and TMA
// do not pay here, where a row of x meets each weight byte once.
//
// Layouts: x [M, K] bf16 or fp16 with row stride ldx (elements); q [K, N]
// int8 row-major, N % 16 == 0, 16-byte aligned; scale [N] fp32; part
// [n_splits, M, N] fp32 and counters [n_tiles] uint32, zero between launches
// (used only when K is split); out [M, N] fp32, bf16 or fp16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cvt4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;               // int8 columns a thread: one 16 B load
constexpr int kTileN = 32 * kCols;      // columns a block: one warp across
constexpr int kMaxRows = 512;           // K rows a block
constexpr int kUnroll = 8;              // row loads a warp keeps in flight
constexpr int kMaxM = 8;

enum OutType { kOutF32 = 0, kOutBF16 = 1, kOutF16 = 2 };

// x's row stride in shared memory: M padded to a vector load.
template <int M>
__host__ __device__ constexpr int x_stride() {
  return M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : 8;
}

template <int S>
__device__ __forceinline__ void load_x(const float* p, float* xr) {
  if constexpr (S == 1) {
    xr[0] = p[0];
  } else if constexpr (S == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    xr[0] = t.x;
    xr[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < S; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + j);
      xr[j] = t.x;
      xr[j + 1] = t.y;
      xr[j + 2] = t.z;
      xr[j + 3] = t.w;
    }
  }
}

// Two neighbouring outputs of row m, scaled, in the output's type.
__device__ __forceinline__ void store2(void* out, int out_type, long idx,
                                       float y0, float y1) {
  if (out_type == kOutF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
        make_float2(y0, y1);
  } else if (out_type == kOutBF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       idx) = __floats2bfloat162_rn(y0, y1);
  } else {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + idx) =
        __floats2half2_rn(y0, y1);
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
dequant_gemv_kernel(const void* __restrict__ x, int x_bf16, int ldx,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    float* __restrict__ part, unsigned* __restrict__ counters,
                    void* __restrict__ out, int out_type, int K, int N,
                    int rows) {
  constexpr int S = x_stride<M>();
  __shared__ __align__(16) float sX[kMaxRows * S];
  __shared__ __align__(16) float sRed[kWarps * kTileN];
  __shared__ int sLast;

  const int tile = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = split * rows;
  const int n = min(rows, K - k0);  // > 0: the host makes ceil(K / rows)
  const int col = tile * kTileN + lane * kCols;

  // This block's rows of x as fp32, [row][S]: coalesced along K.
  for (int i = tid; i < M * n; i += kThreads) {
    const int m = i / n, r = i - m * n;
    const long idx = (long)m * ldx + k0 + r;
    sX[r * S + m] =
        x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[idx])
               : __half2float(static_cast<const __half*>(x)[idx]);
  }
  __syncthreads();

  float acc[M][kCols];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  if (col < N) {  // N % 16 == 0: a thread's 16 columns are all in or out
    const int8_t* qp = q + (long)k0 * N + col;
    for (int r0 = warp; r0 < n; r0 += kWarps * kUnroll) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWarps;
        w[u] = r < n ? __ldcs(reinterpret_cast<const uint4*>(qp + (long)r * N))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWarps;
        if (r < n) {  // warp-uniform
          float xr[S], wf[kCols];
          load_x<S>(sX + r * S, xr);
          cvt4(w[u].x, wf);
          cvt4(w[u].y, wf + 4);
          cvt4(w[u].z, wf + 8);
          cvt4(w[u].w, wf + 12);
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[m][c] = fmaf(xr[m], wf[c], acc[m][c]);
        }
      }
    }
  }

  // The warps' sums, row by row of x, in warp order; each thread then owns
  // two columns of the tile.
  const int c2 = 2 * tid;
  const int n_col = tile * kTileN + c2;
  float2 sc = make_float2(0.f, 0.f);
  if (n_col < N) sc = *reinterpret_cast<const float2*>(scale + n_col);
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; c += 4)
      *reinterpret_cast<float4*>(sRed + warp * kTileN + lane * kCols + c) =
          make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
    __syncthreads();
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 t =
          *reinterpret_cast<const float2*>(sRed + w * kTileN + c2);
      s0 += t.x;
      s1 += t.y;
    }
    if (n_col < N) {
      if (n_splits == 1)
        store2(out, out_type, (long)m * N + n_col, s0 * sc.x, s1 * sc.y);
      else
        *reinterpret_cast<float2*>(part + ((long)split * M + m) * N + n_col) =
            make_float2(s0, s1);
    }
    __syncthreads();
  }
  if (n_splits == 1) return;

  // The last split of this column tile to finish adds them all, in order.
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
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int s = 0; s < n_splits; ++s) {
        const float2 t = __ldcg(
            reinterpret_cast<const float2*>(part + ((long)s * M + m) * N +
                                            n_col));
        s0 += t.x;
        s1 += t.y;
      }
      store2(out, out_type, (long)m * N + n_col, s0 * sc.x, s1 * sc.y);
    }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

template <int M>
cudaError_t launch(const void* x, int x_bf16, int ldx, const void* q,
                   const void* scale, void* part, void* counters, void* out,
                   int out_type, int K, int N, int rows, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (K + rows - 1) / rows);
  dequant_gemv_kernel<M><<<grid, kThreads, 0, stream>>>(
      x, x_bf16, ldx, static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(part),
      static_cast<unsigned*>(counters), out, out_type, K, N, rows);
  return cudaGetLastError();
}

}  // namespace

// y = (x @ q) * scale for M in 1..8 rows; `rows` is the K range of one
// block (1..512): K splits into ceil(K / rows) blocks a column tile, and
// with more than one, `part` and `counters` are the split scratch.
extern "C" int mc_w8a16_gemv(const void* x, const void* q, const void* scale,
                             void* part, void* counters, void* out, int M,
                             int K, int N, int ldx, int rows, int x_bf16,
                             int out_type, void* stream) {
  if (M < 1 || M > kMaxM || K <= 0 || N <= 0 || N % kCols != 0 ||
      rows <= 0 || rows > kMaxRows || (M > 1 && ldx < K) ||
      out_type < kOutF32 || out_type > kOutF16)
    return cudaErrorInvalidValue;
  const int n_splits = (K + rows - 1) / rows;
  if (n_splits > 65535 || (n_splits > 1 && (!part || !counters)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
#define MC_CASE(m)                                                         \
  case m:                                                                  \
    return launch<m>(x, x_bf16, ldx, q, scale, part, counters, out,        \
                     out_type, K, N, rows, st);
    MC_CASE(1)
    MC_CASE(2)
    MC_CASE(3)
    MC_CASE(4)
    MC_CASE(5)
    MC_CASE(6)
    MC_CASE(7)
    MC_CASE(8)
#undef MC_CASE
  }
  return cudaErrorInvalidValue;
}
