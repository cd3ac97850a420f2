// W8A16 dL/dx (kernel K7) for Hopper, sm_90a: the gradient through the
// activations of the int8 product y = (x @ q) * scale, with the frozen int8
// weight q [K, N] and its fp32 scale [N] as the forward read them,
//     dx[m, k] = sum_n T(g[m, n] * scale[n]) * T(q[k, n])
// accumulated in fp32 and written in x's type T (bf16 or fp16); g is the
// cotangent of y, fp32 (the routed products' and the logits') or half.
// Every dL/dx of an int8 product of training on an int8 base (QLoRA):
// the seven a layer and the lm_head's, one a loss chunk.
//
// Replaces no Pallas kernel.  It is the counterpart of what XLA compiles
// for the transposed dot of the JAX package's `dequant_matmul`
// (modelcompose_tpu/ops/quant.py, lines 33-43) under autodiff: the int8 ->
// bf16 convert stays inside the contraction, so no bf16 copy of the weight
// is written.  The plain PyTorch route (ops/quant.py `_dequant_matmul_dx`)
// writes that copy (2 bytes a weight), the scaled cotangent in fp32 and
// again rounded, an fp32 dx from cuBLAS and dx cast once more; this kernel
// writes dx once, in T, and nothing else.  The arithmetic is the plain
// route's: the cotangent times the scale in fp32, rounded to T (the scale
// belongs on g before the rounding: folding it into q would round
// T(q * scale) instead), the exact int8 weight, an fp32 sum, one rounding.
//
// What bounds it on the H100.  By its operations it would be the tensor
// cores (2 M K N flops against 4 M N + K N + 2 M K bytes from device
// memory: ~1,000 flops a byte at the training sizes, where the card needs
// ~295).  What bounds it is the two conversions a tile pays beside its
// products: the int8 weight into the register A operand and the fp32
// cotangent, scaled and rounded, into a bf16 B tile in shared memory.  On
// an H100 (80GB HBM3, 700 W; scripts/torch_k7_parts.py at q/k/v/o's dx,
// 8,192 rows) the products alone run at ~830 TFLOP/s, each conversion
// taken out alone leaves ~570, both in ~400: 40% of the bound.  Three
// earlier layouts measured on the way (scripts/torch_kernel_ab.py --only
// K7): blocks of 128 dx columns re-read the fp32 cotangent from L2 for
// every 128 columns (~0.02 bytes a flop, ~5 TB/s from L2 at 27-29% of the
// bound), loading it into registers instead of staging it by TMA moved as
// much (25-29%), and three converter warps beside the two product
// warpgroups could not keep up (28-29%).  The design, K6's tensor-core GEMM with the weight
// converted on its way to the tensor cores, plus a pass that scales and
// rounds the cotangent in shared memory:
//   - the transposed product.  dx^T[k, m] = sum_n q[k, n] gs^T[n, m] puts
//     64 rows of q in the rows of `wgmma.m64nBMk16` (A, from registers) and
//     BM rows of g in its columns (B, from shared memory K-major); each
//     consumer warpgroup runs two such products a step on one B tile (its
//     128 q rows in two halves), so a converted B tile serves 256 dx
//     columns and the cotangent's L2 traffic is half of 128-column blocks'.
//     q is stored [K, N], contiguous along the contraction, so A needs no
//     byte transpose (K6 needs one): the two k of an A register are two
//     neighbouring bytes of one q row, converted exactly by
//     `hopper::cvt_pair`.  A warp's rows sit 2 apart (thread (w, g) of a
//     half takes q rows 16w + 2g and + 1), so each thread holds two
//     neighbouring columns of dx and stores them as one 4-byte word;
//   - the contraction's order within a 64-deep tile is permuted, A and B
//     alike, so the sum is the same set of products: A register (step st,
//     half h) of thread t4 holds q bytes 16 t4 + 4 st + 2 h and + 1, so a
//     thread reads a row's 16 A words as one 16-byte load (two loads a
//     half).  The q box is [256 rows][64 bytes] under the 64-byte swizzle
//     (the 128-byte one would pad each 64-byte row to a 128-byte line); a
//     warp's two loads (rows 2g and 2g + 1 in an order set by g's parity)
//     meet no bank twice;
//   - the cotangent pass.  TMA brings g's tile [BM][64] (fp32 or half, no
//     swizzle) and the scale's 64 values into the stage; the 256 consumer
//     threads read it in 16-byte vectors (a warp 512 or 256 contiguous
//     bytes), multiply by the scale in fp32, round to T and write the B
//     tile [BM][64] of T under the 128-byte swizzle (`hopper::sw128_offset`,
//     the layout TMA gives K6's x tile) at the permuted k, one 4-byte word
//     a column pair, no bank twice in a store; then `fence.proxy.async` and
//     a named barrier of the two warpgroups hand it to the tensor cores.
//     The q words and the B tile are converted before the stage is freed
//     (release only what has been read, behind the proxy fence), so the
//     stage goes back to the producer at once;
//   - the pipeline.  One producer warp keeps TMA loads of the g, q and
//     scale boxes in flight through a ring of stages (full and empty
//     mbarriers).  The consumers convert tile t + 1 (A words into the
//     other register set, the B tile into the next of three buffers) while
//     the tensor cores run tile t (`wgmma_wait<1>`); a B buffer is
//     rewritten three tiles later, when both warpgroups have passed the
//     barrier that follows their wait on its product.  No split of the
//     contraction: every dx is one block's sum in a fixed order, so the
//     kernel is deterministic (the train step's graph replays stay
//     bit-equal to its eager steps);
//   - the grid.  Blocks of 256 dx columns (two consumer warpgroups of 128)
//     by 128 rows of g, for any M (ops/quant.py `_k7_plan`); a grouped
//     raster (as K6's) walks 8 row tiles under each column tile, so the
//     blocks in flight share their g rows and q rows in L2.  Rows past M, columns past K and the contraction's tail past N
//     are zero-filled by TMA and not stored.
//
// Layouts: g [M, N] fp32, bf16 or fp16, contiguous, 16-byte aligned;
// q [K, N] int8 row-major, K % 8 == 0, N % 16 == 0, 16-byte aligned;
// scale [N] fp32; dx [M, K] in T.

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

constexpr int kBM = 128;       // rows of g (dx rows) a block
constexpr int kBN = 64;        // contraction (N) a stage: 64 columns of g
constexpr int kBK = 256;       // dx columns a block: q rows, 128 a warpgroup
constexpr int kQBytes = kBK * kBN;  // the stage's q box [256][64] int8
constexpr int kScaleBytes = 1024;   // the scale's 64 fp32, padded to 1024
constexpr int kThreads = 384;  // a producer and two consumer warpgroups
constexpr int kMaxStages = 8;
constexpr int kBBufs = 3;      // B tiles: written t, read by t's product
constexpr int kSmemBudget = 220 * 1024;  // of the 227 KB a block may have

enum GType { kGF32 = 0, kGBF16 = 1, kGF16 = 2 };

// A block of 256 dx columns by kBM rows of g.  A stage holds g [kBM][64]
// (G), q [256][64] int8 and the scale's 64 values, each 1024-aligned; then
// three B tiles [kBM][64] of T (128 bytes a row, 128-byte swizzle).
template <typename G>
struct Cfg {
  static constexpr int kGBytes = kBM * kBN * static_cast<int>(sizeof(G));
  static constexpr int kStageBytes = kGBytes + kQBytes + kScaleBytes;
  static constexpr int kBBytes = kBM * kBN * 2;
  static constexpr int kRing = kSmemBudget - kBBufs * kBBytes;
  static constexpr int kStages =
      kRing / kStageBytes < kMaxStages ? kRing / kStageBytes : kMaxStages;
  static constexpr int kBBase = kStages * kStageBytes;
  static constexpr int kBars = kBBase + kBBufs * kBBytes;  // full[], empty[]
  static constexpr int kAlloc = kBars + 2 * kStages * 8 + 1024;
  static constexpr int kAcc = kBM / 2;  // fp32 of an m64nBM product a thread
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// Byte offset of q element (row, col) in the [256][64] box written by TMA
// with the 64-byte swizzle from a 512-aligned base: address bits 4-5 (the
// 16-byte chunk of a row) XORed with bits 7-8.  (The 128-byte swizzle pads
// each 64-byte box row to a 128-byte line: twice the box's bytes.)
__device__ __forceinline__ uint32_t q_offset(int row, int col) {
  const uint32_t a = row * kBN + col;
  return a ^ (((a >> 7) & 3) << 4);
}

// The position in the permuted contraction order of a tile's column n:
// A register (step st, half h) of thread t4 holds q bytes 16 t4 + 4 st +
// 2 h and + 1, whose k in the m64nBMk16 fragment are 16 st + 8 h + 2 t4
// and + 1; B's column k holds the cotangent's column n of the same k.
__device__ __forceinline__ int k_of(int n) {
  return 16 * ((n >> 2) & 3) + 8 * ((n >> 1) & 1) + 2 * (n >> 4) + (n & 1);
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

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_dx_kernel(const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap ts, T* __restrict__ dx,
                int M, int N, int K, int m_tiles, int k_tiles, int group) {
  using C = Cfg<G>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t full0 = sbase + C::kBars;  // + 8 * stage
  const uint32_t empty0 = full0 + 8 * S;    // + 8 * stage
  const int tid = threadIdx.x;

  // The block's tile, in groups of `group` row tiles walked under each
  // column tile (K6's raster): the blocks in flight share g's rows and
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
        prefetch_tensormap(&ts);
      }
      for (int t = 0; t < n_t; ++t) {
        const int s = t % S;
        mbar_wait(empty0 + 8 * s, ((t / S) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t st = sbase + s * C::kStageBytes;
          mbar_arrive_expect_tx(full0 + 8 * s,
                                C::kGBytes + kQBytes + kBN * 4);
          tma_load_3d(st, &tg, full0 + 8 * s, t * kBN, m0, 0);
          tma_load_3d(st + C::kGBytes, &tq, full0 + 8 * s, t * kBN, k0, 0);
          tma_load_3d(st + C::kGBytes + kQBytes, &ts, full0 + 8 * s, t * kBN,
                      0, 0);
        }
        __syncwarp();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int ct = tid - 128;      // 0..255 over both warpgroups
    const int cw = ct / 128;       // which 128 dx columns of the block
    const int t128 = ct % 128;
    const int warp = t128 / 32, lane = t128 % 32;
    const int g = lane / 4, t4 = lane % 4;
    // Each warpgroup runs two m64 products a step on one B tile, over its
    // 128 q rows in two halves of 64.  A rows g and g + 8 of this warp in
    // half hh are q rows q_row + 64 hh and + 1: each thread ends with dx
    // columns k0 + q_row + 64 hh and + 1 of its rows.
    const int q_row = 128 * cw + 16 * warp + 2 * g;
    // A row's 16 A words of a tile are one 16-byte load (the permuted
    // order); the two rows of a thread are loaded in an order set by g's
    // parity, so each quarter-warp's loads meet no bank twice.
    const int odd = g & 1;
    const uint32_t q_first = q_offset(q_row + odd, 16 * t4);
    const uint32_t q_second = q_offset(q_row + 1 - odd, 16 * t4);
    // The B tile's words this thread writes: at its first row, each pair
    // of neighbouring g columns at its permuted k (the swizzle's XOR is
    // the same for every row it writes: they are 16 or 32 apart).
    constexpr int kEpv = std::is_same<G, float>::value ? 4 : 8;
    constexpr int kRowStep = 256 * kEpv / kBN;  // rows between a thread's
    const int cv = ct % (kBN / kEpv);
    const int b_row = ct / (kBN / kEpv);
    uint32_t b_off[kEpv / 2];
#pragma unroll
    for (int e = 0; e < kEpv / 2; ++e)
      b_off[e] = sw128_offset(b_row, k_of(cv * kEpv + 2 * e));

    float acc[2][C::kAcc];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[hh][i] = 0.f;
    // The A fragments of a 64-deep tile, two halves of four 16-deep steps
    // of 4 words; two sets, so the next tile is converted while the tensor
    // cores read this one.
    uint32_t a0[2][16], a1[2][16];

    // A register st * 4 + 2h + e of half hh: q row q_row + 64 hh + e,
    // bytes 16 t4 + 4 st + 2 h and + 1.
    auto convert_q = [&](int s, uint32_t(&a)[2][16]) {
      const uint8_t* qs = smem + s * C::kStageBytes + C::kGBytes;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint4 x = *reinterpret_cast<const uint4*>(
            qs + 64 * kBN * hh + q_first);
        const uint4 y = *reinterpret_cast<const uint4*>(
            qs + 64 * kBN * hh + q_second);
        const uint32_t wx[4] = {x.x, x.y, x.z, x.w};
        const uint32_t wy[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const uint32_t w0 = odd ? wy[st] : wx[st];  // row q_row
          const uint32_t w1 = odd ? wx[st] : wy[st];  // row q_row + 1
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            a[hh][st * 4 + 2 * h] = cvt_pair<T>(w0, w0 >> 8, 2 * h);
            a[hh][st * 4 + 2 * h + 1] = cvt_pair<T>(w1, w1 >> 8, 2 * h);
          }
        }
      }
    };
    // The B tile: g's [kBM][64] tile times the scale, rounded to T, under
    // the 128-byte swizzle, in the permuted order.  fp32 g: thread ct
    // scales columns 4 cv to + 3 of rows b_row + 16 j; half g: columns 8 cv
    // to + 7 of rows b_row + 32 j; each pair one 4-byte word.
    auto convert_g = [&](int s, int b) {
      const uint8_t* gs = smem + s * C::kStageBytes;
      const float* sc = reinterpret_cast<const float*>(gs + C::kGBytes +
                                                       kQBytes);
      uint8_t* bt = smem + C::kBBase + b * C::kBBytes;
      float s_e[kEpv];
#pragma unroll
      for (int e = 0; e < kEpv; e += 4) {
        const float4 f = reinterpret_cast<const float4*>(sc + cv * kEpv)[e / 4];
        s_e[e] = f.x;
        s_e[e + 1] = f.y;
        s_e[e + 2] = f.z;
        s_e[e + 3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < kBM / kRowStep; ++j) {
        const int row = b_row + kRowStep * j;
        const uint4 v =
            reinterpret_cast<const uint4*>(gs + row * kBN * sizeof(G))[cv];
        const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < kEpv; e += 2) {
          float lo, hi;
          if constexpr (std::is_same<G, float>::value) {
            lo = __uint_as_float(in[e]);
            hi = __uint_as_float(in[e + 1]);
          } else {
            lo = half_at<G>(in[e / 2], 0);
            hi = half_at<G>(in[e / 2], 1);
          }
          *reinterpret_cast<uint32_t*>(bt + b_off[e / 2] +
                                       kRowStep * 128 * j) =
              pack2<T>(lo * s_e[e], hi * s_e[e + 1]);
        }
      }
    };
    // The tile's eight products, two a step (one a half) on the B tile
    // advanced 32 bytes (16 columns) a step.
    auto issue = [&](int b, uint32_t(&a)[2][16]) {
      const uint32_t bs = sbase + C::kBBase + b * C::kBBytes;
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          wgmma_rs<T, kBM>(acc[hh], a[hh] + st * 4,
                           sw128_desc(bs + st * 32, 16, 1024));
    };
    auto tile = [&](int t, uint32_t(&cur)[2][16], uint32_t(&prev)[2][16]) {
      const int s = t % S;
      const int b = t % kBBufs;
      mbar_wait(full0 + 8 * s, (t / S) & 1);
      convert_q(s, cur);
      convert_g(s, b);
      // the B tile's writes before the tensor cores read it, and this
      // warp's reads of the stage before TMA writes it again
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      bar_sync(1, 256);  // every B word written
      wgmma_fence();
      issue(b, cur);
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();  // the previous tile's products
        fence_regs(prev);
      }
    };
    for (int t = 0; t < n_t; t += 2) {
      tile(t, a0, a1);
      if (t + 1 < n_t) tile(t + 1, a1, a0);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(a0);
    fence_regs(a1);

    // Thread (warp, g, t4) holds, in half hh, dx columns kb (A row g) and
    // kb + 1 (row g + 8) of rows 8i + 2 t4 + e: one 4-byte word a row.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kb = k0 + q_row + 64 * hh;
      if (kb < K) {  // K % 8 == 0: both columns in or out
#pragma unroll
        for (int i = 0; i < kBM / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * i + 2 * t4 + e;
            if (m < M)
              *reinterpret_cast<uint32_t*>(dx + (long)m * K + kb) =
                  pack2<T>(acc[hh][i * 4 + e], acc[hh][i * 4 + 2 + e]);
          }
      }
    }
  }
}

// The tensor maps of a weight [K][N] int8 in [256][64] boxes under the
// 64-byte swizzle and of its scale [N] in boxes of 64, encoded once per
// weight and kept: a step reuses the same ~225 weights every call.
// Locked: ctypes releases the GIL, so two host threads may launch at once.
bool weight_maps(CUtensorMap* mq, CUtensorMap* ms, const void* q,
                 const void* scale, int K, int N) {
  struct Key {
    const void* q;
    const void* scale;
    int K, N;
    bool operator==(const Key& o) const {
      return q == o.q && scale == o.scale && K == o.K && N == o.N;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.q) ^
             (std::hash<const void*>()(k.scale) << 1) ^ (size_t(k.K) << 20) ^
             k.N;
    }
  };
  struct Maps {
    CUtensorMap q, s;
  };
  static std::unordered_map<Key, Maps, Hash> maps;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  const Key key{q, scale, K, N};
  auto it = maps.find(key);
  if (it != maps.end()) {
    *mq = it->second.q;
    *ms = it->second.s;
    return true;
  }
  if (!make_map_3d(mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K, 1, kBN,
                   kBK, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_3d(ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale, N, 1, 1,
                   kBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
    return false;
  if (maps.size() >= 4096) maps.clear();  // a map is a pure function of key
  maps.emplace(key, Maps{*mq, *ms});
  return true;
}

template <typename G>
CUtensorMapDataType g_type_of() {
  if (std::is_same<G, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (std::is_same<G, __nv_bfloat16>::value)
    return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

template <typename T, typename G>
cudaError_t launch(const void* g, const void* q, const void* scale, void* dx,
                   int M, int K, int N, int group, cudaStream_t stream) {
  using C = Cfg<G>;
  // g's map is encoded per call (its address changes), by value into the
  // kernel's parameters, which a CUDA-graph capture keeps
  CUtensorMap tg, tq, ts;
  if (!make_map_3d(&tg, g_type_of<G>(), sizeof(G), g, N, M, 1, kBN, kBM,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !weight_maps(&tq, &ts, q, scale, K, N))
    return cudaErrorNotSupported;
  // once per instantiation (a thread-safe static), never inside a capture:
  // the first launch of a shape runs eagerly
  static const cudaError_t attribute = cudaFuncSetAttribute(
      w8a16_dx_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kAlloc);
  if (attribute != cudaSuccess) return attribute;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int k_tiles = (K + kBK - 1) / kBK;
  w8a16_dx_kernel<T, G><<<m_tiles * k_tiles, kThreads, C::kAlloc,
                          stream>>>(tg, tq, ts, static_cast<T*>(dx), M, N,
                                    K, m_tiles, k_tiles, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_g(int g_type, const void* g, const void* q,
                 const void* scale, void* dx, int M, int K, int N, int group,
                 cudaStream_t st) {
  switch (g_type) {
    case kGF32:
      return launch<T, float>(g, q, scale, dx, M, K, N, group, st);
    case kGBF16:
      return launch<T, __nv_bfloat16>(g, q, scale, dx, M, K, N, group, st);
    case kGF16:
      return launch<T, __half>(g, q, scale, dx, M, K, N, group, st);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dx = T(g * scale) @ q^T over blocks of 256 dx columns by 128 rows of g,
// `group` row tiles a raster group; g of type `g_type` (0 fp32, 1 bf16,
// 2 fp16), dx in bf16 (x_bf16) or fp16.  Returns cudaErrorInvalidValue,
// launching nothing, for other types, for K % 8 or N % 16 != 0, for an
// empty group and for pointers that are not 16-byte aligned.
extern "C" int mc_w8a16_dx(const void* g, const void* q, const void* scale,
                           void* dx, int M, int K, int N, int group,
                           int g_type, int x_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      group <= 0 || !aligned16(g) || !aligned16(q) || !aligned16(scale) ||
      !aligned16(dx))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_g<__nv_bfloat16>(g_type, g, q, scale, dx, M, K, N, group, st);
  return by_g<__half>(g_type, g, q, scale, dx, M, K, N, group, st);
}

// Dynamic shared memory of one block (bytes), for the build report; -1 for
// a cotangent type K7 does not take.
extern "C" int mc_w8a16_dx_smem(int g_type) {
  switch (g_type) {
    case kGF32:
      return Cfg<float>::kAlloc;
    case kGBF16:
      return Cfg<__nv_bfloat16>::kAlloc;
    case kGF16:
      return Cfg<__half>::kAlloc;
  }
  return -1;
}
