// W8A16 GEMM (kernel K6) for Hopper, sm_90a: more than eight rows of bf16
// or fp16 activations times an int8 weight with one fp32 scale per column,
//     y[m, n] = (sum_k float(x[m, k]) * float(q[k, n])) * scale[n]
// accumulated in fp32, written fp32 or in the activations' type.  The
// prefill's and a chunk's products, and the forward of training on an int8
// base; K5 (w8a16_gemv.cu) takes 1-8 rows.
//
// Replaces no Pallas kernel.  It is the counterpart, at prefill sizes, of
// XLA's fused convert in the JAX package's modelcompose_tpu/ops/quant.py
// `dequant_matmul` (lines 33-43): the int8 -> bf16 convert stays inside the
// contraction, so the int8 tensor is what streams from memory and no bf16
// copy of the weight is ever written.  The plain PyTorch route it replaces
// writes that copy (2 bytes a weight), reads it back in a cuBLAS GEMM, and
// rewrites the fp32 output in a separate scale pass.
//
// What bounds it on the H100: tensor-core operations above about 150 rows
// (2M flops a weight byte against the ~295 the card needs a byte), the int8
// weight's bytes below.  So the design is a tensor-core GEMM whose weight
// operand is converted on its way from shared memory to the tensor cores:
//   - the transposed product.  y^T[n, m] = sum_k q^T[n, k] x^T[k, m] puts
//     64 weight columns in the rows of `wgmma.m64nBMk16` (A, from
//     registers) and BM rows of x in its columns (B, from shared memory
//     K-major, as TMA loads it with the 128-byte swizzle: K1's K operand).
//     The converted weight goes from shared memory to registers to the
//     tensor cores and is never stored again: shared memory carries the
//     int8 bytes once and x's tile (converting into a bf16 tile in shared
//     memory for an SS product would add 3 bytes a weight, beyond what
//     shared memory moves beside the product's own operand reads);
//   - the byte transpose.  A's fragment pairs two k of one column, while
//     q is [K, N] with N contiguous: a thread reads 2 bytes (2 columns)
//     from each of the four k rows its fragment needs (2t, 2t + 1, 2t + 8,
//     2t + 9 of a 16-deep step) and a byte permute pairs the rows
//     (`hopper::cvt_pair`, exact: |q| <= 127 is exact in bf16 and fp16, so
//     the kernel and the plain version multiply the same numbers).  Which
//     weight column sits in which A row is free: thread (warp w, g) of a
//     consumer warpgroup takes columns 16w + 2g and + 1, and the TMA box's
//     128-byte swizzle puts a warp's four rows of one parity on distinct
//     banks;
//   - the conversion's cost.  Converting is ~5 instructions a 2-byte A
//     word, once per 64-deep tile whatever the product's width, so the
//     conversion per flop falls as the product widens: at 256 rows of x a
//     warpgroup's four m64n256k16 products (512 tensor-core clocks) carry
//     ~80 instructions a thread.  On an H100 (80GB HBM3, 700 W; median
//     over the Vicuna-7B layer products at 256-3,328 rows,
//     scripts/torch_k6_blocks.py) blocks of 128 weight columns by 256,
//     128 and 64 rows kept 721, 479 and 314 TFLOP/s within a wave, and
//     764, 734 and 554 with the conversion taken out, so K6 takes 256 rows
//     at prefill sizes and narrower row tiles only where they fill the
//     card better (ops/quant.py `_k6_plan`: the least cost of the waves
//     over the 132 SMs at each block's rate);
//   - the pipeline.  One producer warp keeps TMA loads of x [BM][64] (bf16)
//     and q [64][128] (int8) in flight through a ring of stages with full
//     and empty mbarriers; each of two consumer warpgroups owns 64 weight
//     columns and converts the next 64-deep tile into a second set of
//     registers while the tensor cores run the current one
//     (`wgmma_wait<1>`).  A stage is freed once the products that read its
//     x tile have retired, by when every word of its q tile has been
//     converted.  A grouped raster keeps the weight columns and x rows of
//     the blocks in flight in L2.  No split of K: every output is one
//     block's sum in a fixed order, so the kernel is deterministic;
//   - the epilogue.  Each thread holds 2 consecutive weight columns of 2
//     of every 8 rows, so it scales them by its 2 scales and stores them
//     straight from registers (a warp's stores of a row 64 contiguous
//     bytes at fp32); rows past M and columns past N are not stored (TMA
//     filled them with zeros on load, as it fills K's tail).
//
// Layouts: x [M, K] bf16 or fp16, contiguous, K % 8 == 0 (TMA's 16-byte
// row stride), 16-byte aligned; q [K, N] int8 row-major, N % 16 == 0,
// 16-byte aligned; scale [N] fp32; out [M, N] fp32, bf16 or fp16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;         // K rows a stage: x's 128-byte box
constexpr int kBN = 128;        // weight columns a block: one int8 box
constexpr int kQBytes = kBK * kBN;  // the stage's q box [64][128]
constexpr int kThreads = 384;   // a producer and two consumer warpgroups
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 200 * 1024;  // of the 227 KB a block may have

enum OutType { kOutF32 = 0, kOutBF16 = 1, kOutF16 = 2 };

// A block of 128 weight columns (64 a consumer warpgroup) by kBM rows of x.
// A stage holds x [kBM][64] bf16 and q [64][128] int8, one TMA box each,
// 1024-aligned under the 128-byte swizzle.
template <int kBM>
struct Cfg {
  static constexpr int kXBytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kStages = kRingBudget / kStageBytes < kMaxStages
                                     ? kRingBudget / kStageBytes
                                     : kMaxStages;
  static constexpr int kBars = kStages * kStageBytes;  // full[], empty[]
  static constexpr int kAlloc = kBars + 2 * kStages * 8 + 1024;
  static constexpr int kAcc = kBM / 2;  // fp32 of the m64nBM product a thread
};

// Two neighbouring outputs of one row, in the output's type.
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

template <typename T, int kBM>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tq,
                  const float* __restrict__ scale, void* __restrict__ out,
                  int out_type, int M, int N, int K, int m_tiles,
                  int n_tiles, int group) {
  using C = Cfg<kBM>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t full0 = sbase + C::kBars;  // + 8 * stage
  const uint32_t empty0 = full0 + 8 * S;    // + 8 * stage
  const int tid = threadIdx.x;

  // The block's tile, in groups of `group` row tiles: consecutive blocks
  // walk the group's row tiles under one column tile, so the blocks in
  // flight share their weight columns and their rows of x in L2.
  const int per_group = group * n_tiles;
  const int first = static_cast<int>(blockIdx.x) / per_group * group;
  const int rows_here = min(m_tiles - first, group);
  const int r = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first + r % rows_here) * kBM;
  const int n0 = r / rows_here * kBN;
  const int n_k = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival + bytes
      mbar_init(empty0 + 8 * s, 8);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (tid < 32) {  // the whole warp walks the ring; lane 0 issues
      const int lane = tid;
      if (lane == 0) {
        prefetch_tensormap(&tx);
        prefetch_tensormap(&tq);
      }
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % S;
        mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t st = sbase + s * C::kStageBytes;
          mbar_arrive_expect_tx(full0 + 8 * s, C::kStageBytes);
          tma_load_3d(st, &tx, full0 + 8 * s, kt * kBK, m0, 0);
          tma_load_3d(st + C::kXBytes, &tq, full0 + 8 * s, n0, kt * kBK, 0);
        }
        __syncwarp();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int cw = tid / 128 - 1;  // which 64 weight columns of the tile
    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, t4 = lane % 4;
    // Thread (warp, g, t4) reads weight columns col and col + 1 (A rows g
    // and g + 8 of its warp's 16) from rows 2 t4, 2 t4 + 1, 2 t4 + 8 and
    // 2 t4 + 9 of every 16-row step of the q box: the 16-byte chunk of col,
    // XORed with the row's parity group under the swizzle (rows 8 apart
    // share it), so a warp's reads of one row parity meet no bank twice.
    const int col = 64 * cw + 16 * warp + 2 * g;
    const int chunk = col / 16;
    const uint32_t q_even =
        2 * t4 * 128 + (((chunk ^ (2 * t4)) & 7) << 4) + col % 16;
    const uint32_t q_odd =
        (2 * t4 + 1) * 128 + (((chunk ^ (2 * t4 + 1)) & 7) << 4) + col % 16;

    float acc[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
    // The A fragments of a 64-deep tile, four 16-deep steps of 4 words;
    // two sets, so the next tile is converted while the tensor cores read
    // this one.
    uint32_t a0[16], a1[16];

    auto convert = [&](int s, uint32_t(&a)[16]) {
      const uint8_t* qs = smem + s * C::kStageBytes + C::kXBytes;
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint8_t* rows = qs + st * 16 * 128;
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(rows + q_even);
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(rows + q_odd);
        const uint32_t w2 =
            *reinterpret_cast<const uint16_t*>(rows + 8 * 128 + q_even);
        const uint32_t w3 =
            *reinterpret_cast<const uint16_t*>(rows + 8 * 128 + q_odd);
        a[st * 4 + 0] = cvt_pair<T>(w0, w1, 0);  // row g, k 2t4, 2t4 + 1
        a[st * 4 + 1] = cvt_pair<T>(w0, w1, 1);  // row g + 8
        a[st * 4 + 2] = cvt_pair<T>(w2, w3, 0);  // row g, k 2t4 + 8, + 9
        a[st * 4 + 3] = cvt_pair<T>(w2, w3, 1);  // row g + 8
      }
    };
    // The tile's four products: x's box advanced 32 bytes (16 columns) a
    // step.
    auto issue = [&](int s, uint32_t(&a)[16]) {
      const uint32_t xs = sbase + s * C::kStageBytes;
#pragma unroll
      for (int st = 0; st < 4; ++st)
        wgmma_rs<T, kBM>(acc, a + st * 4, sw128_desc(xs + st * 32, 16, 1024));
    };
    // A stage is free once the products that read its x tile have retired
    // (its q words were converted before they were issued); the proxy
    // fence orders this warp's reads of it before TMA's next write.
    auto release = [&](int s) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    };
    auto tile = [&](int kt, uint32_t(&cur)[16], uint32_t(&prev)[16]) {
      const int s = kt % S;
      mbar_wait(full0 + 8 * s, (kt / S) & 1);
      convert(s, cur);
      wgmma_fence();
      issue(s, cur);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();  // the previous tile's products
        fence_words(prev);
        release((kt - 1) % S);
      }
    };
    for (int kt = 0; kt < n_k; kt += 2) {
      tile(kt, a0, a1);
      if (kt + 1 < n_k) tile(kt + 1, a1, a0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_words(a0);
    fence_words(a1);
    release((n_k - 1) % S);

    // Thread (warp, g, t4) holds weight columns nb (A row g) and nb + 1
    // (row g + 8) of rows 8i + 2 t4 + e: scaled, 8 bytes a row (fp32), a
    // warp's stores of a row 64 contiguous bytes.
    const int nb = n0 + col;
    if (nb < N) {  // N % 16 == 0: both columns in or out
      const float2 sc = *reinterpret_cast<const float2*>(scale + nb);
#pragma unroll
      for (int i = 0; i < kBM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * i + 2 * t4 + e;
          if (m < M)
            store2(out, out_type, (long)m * N + nb, acc[i * 4 + e] * sc.x,
                   acc[i * 4 + 2 + e] * sc.y);
        }
    }
  }
}

// The tensor map of a weight [K][N] int8 in [64][128] boxes under the
// 128-byte swizzle, encoded once per weight and kept: a prefill reuses the
// same ~225 weights every call.  Locked: ctypes releases the GIL, so two
// host threads may launch at once.
bool weight_map(CUtensorMap* map, const void* q, int K, int N) {
  struct Key {
    const void* q;
    int K, N;
    bool operator==(const Key& o) const {
      return q == o.q && K == o.K && N == o.N;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.q) ^ (size_t(k.K) << 20) ^ k.N;
    }
  };
  static std::unordered_map<Key, CUtensorMap, Hash> maps;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  const Key key{q, K, N};
  auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  if (!make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K, 1, kBN,
                   kBK, CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (maps.size() >= 4096) maps.clear();  // a map is a pure function of key
  maps.emplace(key, *map);
  return true;
}

template <typename T, int kBM>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out,
                   int out_type, int M, int K, int N, int group,
                   cudaStream_t stream) {
  using C = Cfg<kBM>;
  // x's map is encoded per call (its address changes), by value into the
  // kernel's parameters, which a CUDA-graph capture keeps
  CUtensorMap tx, tq;
  const auto type = std::is_same<T, __nv_bfloat16>::value
                        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (!make_map_3d(&tx, type, 2, x, K, M, 1, kBK, kBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !weight_map(&tq, q, K, N))
    return cudaErrorNotSupported;
  // once per instantiation (a thread-safe static), never inside a capture:
  // the first launch of a shape runs eagerly
  static const cudaError_t attribute = cudaFuncSetAttribute(
      w8a16_gemm_kernel<T, kBM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kAlloc);
  if (attribute != cudaSuccess) return attribute;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  w8a16_gemm_kernel<T, kBM><<<m_tiles * n_tiles, kThreads, C::kAlloc,
                              stream>>>(
      tx, tq, static_cast<const float*>(scale), out, out_type, M, N, K,
      m_tiles, n_tiles, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int rows, const void* x, const void* q,
                     const void* scale, void* out, int out_type, int M, int K,
                     int N, int group, cudaStream_t st) {
  switch (rows) {
    case 64:
      return launch<T, 64>(x, q, scale, out, out_type, M, K, N, group, st);
    case 128:
      return launch<T, 128>(x, q, scale, out, out_type, M, K, N, group, st);
    case 256:
      return launch<T, 256>(x, q, scale, out, out_type, M, K, N, group, st);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y = (x @ q) * scale over blocks of 128 weight columns by `rows` (64, 128
// or 256) rows of x, `group` row tiles a raster group.  Returns
// cudaErrorInvalidValue, launching nothing, for other rows, for K % 8 or
// N % 16 != 0 and for pointers that are not 16-byte aligned.
extern "C" int mc_w8a16_gemm(const void* x, const void* q, const void* scale,
                             void* out, int M, int K, int N, int rows,
                             int group, int x_bf16, int out_type,
                             void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      group <= 0 || out_type < kOutF32 || out_type > kOutF16 ||
      !aligned16(x) || !aligned16(q) || !aligned16(scale) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(rows, x, q, scale, out, out_type, M, K, N,
                                   group, st);
  return dispatch<__half>(rows, x, q, scale, out, out_type, M, K, N, group,
                          st);
}

// Dynamic shared memory of one block (bytes), for the build report; -1 for
// rows K6 does not take.
extern "C" int mc_w8a16_gemm_smem(int rows) {
  switch (rows) {
    case 64:
      return Cfg<64>::kAlloc;
    case 128:
      return Cfg<128>::kAlloc;
    case 256:
      return Cfg<256>::kAlloc;
  }
  return -1;
}
