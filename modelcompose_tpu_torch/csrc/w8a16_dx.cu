// W8A16 dL/dx (kernel K7) for Hopper, sm_90a: the gradient through the
// activations of the int8 product y = (x @ q) * scale, with the frozen int8
// weight q [K, N] and its fp32 scale [N] as the forward read them,
//     gs[m, n] = T(g[m, n] * scale[n])
//     dx[m, k] = sum_n gs[m, n] * T(q[k, n])
// the first product in fp32 and rounded once to x's type T (bf16 or fp16),
// the sum accumulated in fp32 and rounded once to T; g is the cotangent of
// y, fp32 (the routed products' and the logits') or half.  Every dL/dx of
// an int8 product of training on an int8 base (QLoRA): the seven a layer
// and the lm_head's, one a loss chunk.
//
// Replaces no Pallas kernel.  It is the counterpart of what XLA compiles
// for the transposed dot of the JAX package's `dequant_matmul`
// (modelcompose_tpu/ops/quant.py, lines 33-43) under autodiff: the int8 ->
// bf16 convert stays inside the contraction, so no bf16 copy of the weight
// is written.  The plain PyTorch route (ops/quant.py `_dequant_matmul_dx`)
// writes that copy (2 bytes a weight), the scaled cotangent in fp32 and
// again rounded, an fp32 dx from cuBLAS and dx cast once more.  The
// arithmetic is the plain route's: the cotangent times the scale in fp32,
// rounded to T (the scale belongs on g before the rounding: folding it into
// q would round T(q * scale) instead), the exact int8 weight, an fp32 sum,
// one rounding.
//
// What bounds it on the H100: the tensor cores (2 M K N flops against
// 4 M N + K N + 2 M K bytes: ~1,000 flops a byte at the training sizes,
// where the card needs ~295), if the two conversions a tile needs stay off
// their critical path.  So K7 is two passes, launched by one call on one
// stream:
//   - pass 1, the scaled cotangent, once.  `w8a16_dx_scale_kernel` reads g
//     (16 bytes a thread, each element once), multiplies by the scale in
//     fp32, rounds to T and writes gs [M, N]: 6 M N bytes at an fp32 g, at
//     device-memory speed (60 us at q/k/v/o's 8,192 x 4,096), bit-equal to
//     the plain route's `_scale_cotangent`.  The scratch gs is the
//     wrapper's (`torch.empty`; a capture's comes from the graph's pool);
//   - pass 2, the product on K6's skeleton (w8a16_gemm.cu).  dx^T[k, m] =
//     sum_n q[k, n] gs^T[n, m] puts 64 rows of q in the rows of
//     `wgmma.m64nBMk16` (A, from registers) and BM rows of gs in its columns
//     (B): gs's [BM][64] tile comes by TMA under the 128-byte swizzle,
//     exactly as K6's x tile, and goes to the tensor cores with no
//     conversion and no shared-memory pass.  A is q's [128][64] int8 box
//     (64-byte swizzle: the 128-byte one pads a 64-byte box row to a
//     128-byte line), converted into registers: q is [K, N], contiguous
//     along the contraction, so the two k of an A register are two
//     neighbouring bytes of one q row, one 2-byte read, converted exactly
//     by `hopper::cvt_pair` (no byte transpose, which K6 needs).  Thread
//     (warp w, g) of a consumer warpgroup takes q rows 16 w + g and + 8 (A
//     rows g and g + 8), so a warp's reads meet no bank twice under the
//     swizzle;
//   - the pipeline (K6's).  One producer warp keeps TMA loads of the gs
//     and q boxes in flight through a ring of stages (a stage holds BM x
//     128 bytes of gs and 8 KB of q, 200 KB in all); the two consumer
//     warpgroups convert the next tile's A words while the tensor cores
//     run this one (`wgmma_wait<1>`), and free a stage once the products
//     that read its gs tile have retired;
//   - the grid.  Blocks of 128 dx columns by BM = 256 or 128 rows of gs
//     (ops/quant.py `_k7_plan`: the block whose waves over the 132 SMs
//     cost least; 256 at the train sizes), a grouped raster (K6's) of 8
//     row tiles under each column tile.  No split of the contraction:
//     every dx is one block's sum in a fixed order, so the kernel is
//     deterministic (the train step's graph replays stay bit-equal to its
//     eager steps).  Rows past M, columns past K and the contraction's tail
//     past N are zero-filled by TMA and not stored.
// The conversion of an A word is paid once a 64-deep tile whatever BM, so
// 256-row blocks halve it per flop: on an H100 (80GB HBM3, 700 W;
// scripts/torch_k7_parts.py) they keep 721 TFLOP/s in a wave, 128-row ones
// 497 (K6's: 721, 479).  The cost of the split: one write and one read of
// gs (2 M N bytes of T more device traffic, 64 MB at q/k/v/o's 8,192 rows)
// and the scratch.  Measured at 8,192 rows: pass 1 at 2.80-2.94 TB/s
// (0.072 ms at q/k/v/o), pass 2 at 658-699 TFLOP/s, 709-773 without the A
// conversion and 797-835 without it and the loads; K7 0.474-0.476 ms at
// q/k/v/o, 58% of its bound.
//
// The earlier design (measured on an H100 80GB HBM3 at 700 W;
// scripts/torch_kernel_ab.py --only K7, scripts/torch_k7_parts.py) did the
// scaling inside the product: g's fp32 tile came by TMA and the 256
// consumer threads scaled, rounded and wrote it into a swizzled B tile in
// shared memory, blocks of 256 dx columns (two m64 products a warpgroup on
// one B tile) by 128 rows, the contraction order permuted so a row's A
// words were one 16-byte load.  It kept ~400 TFLOP/s (39-42% of the bound;
// q/k/v/o's dx 0.686-0.696 ms at 8,192 rows): the products alone ran at
// ~850, without the B conversion 557-565, without the A one 575-576, since
// every block along dx's columns redid the B conversion (K / 256 times an
// element: 16 at q/k/v/o, 43 at down) on the product warps' critical path,
// and each A conversion served only 128 rows.  Layouts measured on the way
// and slower still: blocks of 128 dx columns (27-29% of the bound: g
// re-read from L2 for every 128 columns), g loaded into registers instead
// of staged by TMA (25-29%), three converter warps beside the two product
// warpgroups (28-29%).
//
// Layouts: g [M, N] fp32, bf16 or fp16, contiguous, 16-byte aligned;
// q [K, N] int8 row-major, K % 8 == 0, N % 16 == 0, 16-byte aligned;
// scale [N] fp32; gs [M, N] in T (scratch); dx [M, K] in T.

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

enum GType { kGF32 = 0, kGBF16 = 1, kGF16 = 2 };

// ------------------------------------------------------------------ pass 1

constexpr int kScaleThreads = 256;
constexpr int kScaleUnroll = 4;  // 16-byte loads in flight a thread

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

// The low (p = 0) or high (p = 1) half of a word of two G values, as fp32.
template <typename G>
__device__ __forceinline__ float half_at(uint32_t w, int p) {
  const uint16_t h = static_cast<uint16_t>(w >> (16 * p));
  if constexpr (std::is_same<G, __nv_bfloat16>::value) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  } else {
    return __half2float(__ushort_as_half(h));
  }
}

// gs = T(float(g) * scale) over g's M N elements in 16-byte vectors (kEpv
// elements; N % 16 == 0, so a vector never crosses a row): thread t of a
// block takes the vectors t, t + 256, ... (kScaleUnroll of them) of the
// block's run; loads first, then the products and the stores (8 bytes of
// T for an fp32 vector, 16 for half).
template <typename T, typename G>
__global__ void __launch_bounds__(kScaleThreads)
w8a16_dx_scale_kernel(const G* __restrict__ g,
                      const float* __restrict__ scale, T* __restrict__ gs,
                      int N, long vectors) {
  constexpr int kEpv = 16 / static_cast<int>(sizeof(G));
  const long first = static_cast<long>(blockIdx.x) * kScaleThreads *
                         kScaleUnroll + threadIdx.x;
  uint4 in[kScaleUnroll];
#pragma unroll
  for (int u = 0; u < kScaleUnroll; ++u) {
    const long v = first + static_cast<long>(u) * kScaleThreads;
    if (v < vectors) in[u] = __ldcs(reinterpret_cast<const uint4*>(g) + v);
  }
#pragma unroll
  for (int u = 0; u < kScaleUnroll; ++u) {
    const long v = first + static_cast<long>(u) * kScaleThreads;
    if (v >= vectors) break;
    const uint32_t w[4] = {in[u].x, in[u].y, in[u].z, in[u].w};
    float f[kEpv];
#pragma unroll
    for (int e = 0; e < kEpv; ++e) {
      if constexpr (std::is_same<G, float>::value)
        f[e] = __uint_as_float(w[e]);
      else
        f[e] = half_at<G>(w[e / 2], e % 2);
    }
    const int col = static_cast<int>(v * kEpv % N);
    const float4* sc = reinterpret_cast<const float4*>(scale + col);
    uint32_t out[kEpv / 2];
#pragma unroll
    for (int e = 0; e < kEpv; e += 4) {
      const float4 s = __ldg(sc + e / 4);
      out[e / 2] = pack2<T>(__fmul_rn(f[e], s.x), __fmul_rn(f[e + 1], s.y));
      out[e / 2 + 1] =
          pack2<T>(__fmul_rn(f[e + 2], s.z), __fmul_rn(f[e + 3], s.w));
    }
    T* dst = gs + v * kEpv;
    if constexpr (kEpv == 4)
      *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
    else
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(out[0], out[1], out[2], out[3]);
  }
}

template <typename T, typename G>
cudaError_t launch_scale(const void* g, const void* scale, void* gs, int M,
                         int N, cudaStream_t stream) {
  constexpr int kEpv = 16 / static_cast<int>(sizeof(G));
  const long vectors = static_cast<long>(M) * N / kEpv;
  const long per_block = kScaleThreads * kScaleUnroll;
  w8a16_dx_scale_kernel<T, G>
      <<<static_cast<unsigned>((vectors + per_block - 1) / per_block),
         kScaleThreads, 0, stream>>>(
          static_cast<const G*>(g), static_cast<const float*>(scale),
          static_cast<T*>(gs), N, vectors);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scale_by_g(int g_type, const void* g, const void* scale,
                       void* gs, int M, int N, cudaStream_t st) {
  switch (g_type) {
    case kGF32:
      return launch_scale<T, float>(g, scale, gs, M, N, st);
    case kGBF16:
      return launch_scale<T, __nv_bfloat16>(g, scale, gs, M, N, st);
    case kGF16:
      return launch_scale<T, __half>(g, scale, gs, M, N, st);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ pass 2

constexpr int kBN = 64;         // contraction (N) a stage: gs's 128-byte box
constexpr int kBK = 128;        // dx columns a block: q rows, 64 a warpgroup
constexpr int kQBytes = kBK * kBN;  // the stage's q box [128][64] int8
constexpr int kThreads = 384;   // a producer and two consumer warpgroups
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 200 * 1024;  // of the 227 KB a block may have

// A block of 128 dx columns (64 a consumer warpgroup) by kBM rows of gs.
// A stage holds gs [kBM][64] of T (128-byte swizzle) and q [128][64] int8
// (64-byte swizzle), one TMA box each, 1024-aligned.
template <int kBM>
struct Cfg {
  static constexpr int kGBytes = kBM * kBN * 2;
  static constexpr int kStageBytes = kGBytes + kQBytes;
  static constexpr int kStages = kRingBudget / kStageBytes < kMaxStages
                                     ? kRingBudget / kStageBytes
                                     : kMaxStages;
  static constexpr int kBars = kStages * kStageBytes;  // full[], empty[]
  static constexpr int kAlloc = kBars + 2 * kStages * 8 + 1024;
  static constexpr int kAcc = kBM / 2;  // fp32 of the m64nBM product a thread
};

// Byte offset of q element (row, col) in the [128][64] box written by TMA
// with the 64-byte swizzle from a 512-aligned base: address bits 4-5 (the
// 16-byte chunk of a row) XORed with bits 7-8.
__device__ __forceinline__ uint32_t q_offset(int row, int col) {
  const uint32_t a = row * kBN + col;
  return a ^ (((a >> 7) & 3) << 4);
}

// One fp32 value rounded to T.
template <typename T>
__device__ __forceinline__ T to_t(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else
    return __float2half_rn(v);
}

template <typename T, int kBM>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_dx_kernel(const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tq, T* __restrict__ dx,
                int M, int N, int K, int m_tiles, int k_tiles, int group) {
  using C = Cfg<kBM>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t full0 = sbase + C::kBars;  // + 8 * stage
  const uint32_t empty0 = full0 + 8 * S;    // + 8 * stage
  const int tid = threadIdx.x;

  // The block's tile, in groups of `group` row tiles walked under each
  // column tile (K6's raster): the blocks in flight share gs's rows and
  // q's rows in L2.
  const int per_group = group * k_tiles;
  const int first = static_cast<int>(blockIdx.x) / per_group * group;
  const int rows_here = min(m_tiles - first, group);
  const int r = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first + r % rows_here) * kBM;
  const int k0 = r / rows_here * kBK;
  const int n_t = (N + kBN - 1) / kBN;

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
        prefetch_tensormap(&tg);
        prefetch_tensormap(&tq);
      }
      for (int t = 0; t < n_t; ++t) {
        const int s = t % S;
        mbar_wait(empty0 + 8 * s, ((t / S) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t st = sbase + s * C::kStageBytes;
          mbar_arrive_expect_tx(full0 + 8 * s, C::kStageBytes);
          tma_load_3d(st, &tg, full0 + 8 * s, t * kBN, m0, 0);
          tma_load_3d(st + C::kGBytes, &tq, full0 + 8 * s, t * kBN, k0, 0);
        }
        __syncwarp();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int cw = tid / 128 - 1;  // which 64 dx columns of the block
    const int t128 = tid % 128;
    const int warp = t128 / 32, lane = t128 % 32;
    const int g = lane / 4, t4 = lane % 4;
    // A rows g and g + 8 of this warp are q rows q_row and q_row + 8 of the
    // box; the A register (step st, half h, row j) holds bytes 16 st + 8 h
    // + 2 t4 and + 1 of its row.  Rows 8 apart share the swizzle's XOR, and
    // a warp's eight rows of one j fall on eight distinct 4-bank groups.
    const int q_row = 64 * cw + 16 * warp + g;
    uint32_t q_at[4];  // byte offset of (q_row, 16 st + 2 t4) in the box
#pragma unroll
    for (int st = 0; st < 4; ++st) q_at[st] = q_offset(q_row, 16 * st + 2 * t4);

    float acc[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
    // The A fragments of a 64-deep tile, four 16-deep steps of 4 words;
    // two sets, so the next tile is converted while the tensor cores read
    // this one.
    uint32_t a0[16], a1[16];

    auto convert = [&](int s, uint32_t(&a)[16]) {
      const uint8_t* qs = smem + s * C::kStageBytes + C::kGBytes;
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t w = *reinterpret_cast<const uint16_t*>(
                qs + q_at[st] + 8 * h + 8 * kBN * j);
            a[st * 4 + 2 * h + j] = cvt_pair<T>(w, w >> 8, 0);
          }
    };
    // The tile's four products: gs's box advanced 32 bytes (16 columns) a
    // step.
    auto issue = [&](int s, uint32_t(&a)[16]) {
      const uint32_t gt = sbase + s * C::kStageBytes;
#pragma unroll
      for (int st = 0; st < 4; ++st)
        wgmma_rs<T, kBM>(acc, a + st * 4, sw128_desc(gt + st * 32, 16, 1024));
    };
    // A stage is free once the products that read its gs tile have
    // retired (its q words were converted before they were issued); the
    // proxy fence orders this warp's reads of it before TMA's next write.
    auto release = [&](int s) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    };
    auto tile = [&](int t, uint32_t(&cur)[16], uint32_t(&prev)[16]) {
      const int s = t % S;
      mbar_wait(full0 + 8 * s, (t / S) & 1);
      convert(s, cur);
      wgmma_fence();
      issue(s, cur);
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();  // the previous tile's products
        fence_words(prev);
        release((t - 1) % S);
      }
    };
    for (int t = 0; t < n_t; t += 2) {
      tile(t, a0, a1);
      if (t + 1 < n_t) tile(t + 1, a1, a0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_words(a0);
    fence_words(a1);
    release((n_t - 1) % S);

    // Thread (warp, g, t4) holds dx columns kc (A row g) and kc + 8 (row
    // g + 8) of rows 8i + 2 t4 + e.  K % 8 == 0: kc's group of 8 columns is
    // in or out whole.
    const int kc = k0 + q_row;
    const bool lo = kc < K, hi = kc + 8 < K;
#pragma unroll
    for (int i = 0; i < kBM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * i + 2 * t4 + e;
        if (m < M) {
          T* row = dx + static_cast<long>(m) * K + kc;
          if (lo) row[0] = to_t<T>(acc[i * 4 + e]);
          if (hi) row[8] = to_t<T>(acc[i * 4 + 2 + e]);
        }
      }
  }
}

// The tensor map of a weight [K][N] int8 in [128][64] boxes under the
// 64-byte swizzle, encoded once per weight and kept: a step reuses the same
// ~225 weights every call.  Locked: ctypes releases the GIL, so two host
// threads may launch at once.
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
                   kBK, CU_TENSOR_MAP_SWIZZLE_64B))
    return false;
  if (maps.size() >= 4096) maps.clear();  // a map is a pure function of key
  maps.emplace(key, *map);
  return true;
}

template <typename T, int kBM>
cudaError_t launch_product(const void* gs, const void* q, void* dx, int M,
                           int K, int N, int group, cudaStream_t stream) {
  using C = Cfg<kBM>;
  // gs's map is encoded per call (its address changes), by value into the
  // kernel's parameters, which a CUDA-graph capture keeps
  CUtensorMap tg, tq;
  const auto type = std::is_same<T, __nv_bfloat16>::value
                        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (!make_map_3d(&tg, type, 2, gs, N, M, 1, kBN, kBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !weight_map(&tq, q, K, N))
    return cudaErrorNotSupported;
  // once per instantiation (a thread-safe static), never inside a capture:
  // the first launch of a shape runs eagerly
  static const cudaError_t attribute = cudaFuncSetAttribute(
      w8a16_dx_kernel<T, kBM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kAlloc);
  if (attribute != cudaSuccess) return attribute;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int k_tiles = (K + kBK - 1) / kBK;
  w8a16_dx_kernel<T, kBM><<<m_tiles * k_tiles, kThreads, C::kAlloc,
                            stream>>>(tg, tq, static_cast<T*>(dx), M, N, K,
                                      m_tiles, k_tiles, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t product_by_rows(int rows, const void* gs, const void* q,
                            void* dx, int M, int K, int N, int group,
                            cudaStream_t st) {
  switch (rows) {
    case 128:
      return launch_product<T, 128>(gs, q, dx, M, K, N, group, st);
    case 256:
      return launch_product<T, 256>(gs, q, dx, M, K, N, group, st);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// What pass 1 takes: a known cotangent type, N % 16 == 0 (whole 16-byte
// vectors of g and of gs a row), 16-byte aligned pointers.
bool scale_args_ok(const void* g, const void* scale, const void* gs, int M,
                   int N, int g_type) {
  return g_type >= kGF32 && g_type <= kGF16 && M > 0 && N > 0 &&
         N % 16 == 0 && aligned16(g) && aligned16(scale) && aligned16(gs);
}

bool product_args_ok(const void* gs, const void* q, const void* dx, int M,
                     int K, int N, int rows, int group) {
  return M > 0 && K > 0 && N > 0 && K % 8 == 0 && N % 16 == 0 &&
         (rows == 128 || rows == 256) && group > 0 && aligned16(gs) &&
         aligned16(q) && aligned16(dx);
}

}  // namespace

// Pass 1, gs = T(g * scale): g contiguous, of type `g_type` (0 fp32,
// 1 bf16, 2 fp16), gs in bf16 (x_bf16) or fp16.  Returns
// cudaErrorInvalidValue, launching nothing, for another type, N % 16 != 0
// or pointers that are not 16-byte aligned.
extern "C" int mc_w8a16_dx_scale(const void* g, const void* scale, void* gs,
                                 int M, int N, int g_type, int x_bf16,
                                 void* stream) {
  if (!scale_args_ok(g, scale, gs, M, N, g_type))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? scale_by_g<__nv_bfloat16>(g_type, g, scale, gs, M, N, st)
                : scale_by_g<__half>(g_type, g, scale, gs, M, N, st);
}

// Pass 2, dx = gs @ q^T over blocks of 128 dx columns by `rows` (128 or
// 256) rows of gs, `group` row tiles a raster group; gs and dx in bf16
// (x_bf16) or fp16.  Returns cudaErrorInvalidValue, launching nothing,
// for other rows, K % 8 or N % 16 != 0, an empty group and pointers that
// are not 16-byte aligned.
extern "C" int mc_w8a16_dx_product(const void* gs, const void* q, void* dx,
                                   int M, int K, int N, int rows, int group,
                                   int x_bf16, void* stream) {
  if (!product_args_ok(gs, q, dx, M, K, N, rows, group))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? product_by_rows<__nv_bfloat16>(rows, gs, q, dx, M, K, N,
                                                 group, st)
                : product_by_rows<__half>(rows, gs, q, dx, M, K, N, group,
                                          st);
}

// K7, dx = T(g * scale) @ q^T: the two passes above in order on `stream`,
// launching neither unless both take their arguments.
extern "C" int mc_w8a16_dx(const void* g, const void* q, const void* scale,
                           void* gs, void* dx, int M, int K, int N, int rows,
                           int group, int g_type, int x_bf16, void* stream) {
  if (!scale_args_ok(g, scale, gs, M, N, g_type) ||
      !product_args_ok(gs, q, dx, M, K, N, rows, group))
    return cudaErrorInvalidValue;
  const int err = mc_w8a16_dx_scale(g, scale, gs, M, N, g_type, x_bf16,
                                    stream);
  return err != cudaSuccess ? err
                            : mc_w8a16_dx_product(gs, q, dx, M, K, N, rows,
                                                  group, x_bf16, stream);
}

// Dynamic shared memory of one product block (bytes), for the build
// report; -1 for rows K7 does not take.
extern "C" int mc_w8a16_dx_smem(int rows) {
  switch (rows) {
    case 128:
      return Cfg<128>::kAlloc;
    case 256:
      return Cfg<256>::kAlloc;
  }
  return -1;
}
