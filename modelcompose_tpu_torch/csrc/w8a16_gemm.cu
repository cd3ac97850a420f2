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
//     tensor cores and is never stored again;
//   - the byte transpose.  A's fragment pairs two k of one column, while
//     q is [K, N] with N contiguous: a thread reads 2 bytes (2 columns)
//     from each of the four k rows its fragment needs (2t, 2t + 1, 2t + 8,
//     2t + 9 of a 16-deep step) and a byte permute pairs the rows
//     (`hopper::cvt_pair`, exact: |q| <= 127 is exact in bf16 and fp16).
//     Thread (warp w, g) of a consumer warpgroup takes columns 16w + 2g
//     and + 1, and the TMA box's 128-byte swizzle puts a warp's four rows
//     of one parity on distinct banks;
//   - the conversion's cost.  Converting is ~5 instructions a 2-byte A
//     word, once per 64-deep tile whatever the product's width, so wide
//     blocks amortize it: 256 rows of x by 128 weight columns is the
//     block that keeps the tensor cores busiest (ops/quant.py `_K6_RATES`,
//     measured by scripts/torch_k6_blocks.py);
//   - the pipeline.  One producer warp keeps TMA loads of x [BM][64] (bf16)
//     and q [64][128] (int8) in flight through a ring of stages with full
//     and empty mbarriers; each of two consumer warpgroups owns 64 weight
//     columns and converts the next 64-deep tile into a second set of
//     registers while the tensor cores run the current one
//     (`wgmma_wait<1>`).  A stage is freed once the products that read its
//     x tile have retired, by when every word of its q tile has been
//     converted.
//
// The grid: persistent blocks over a static list of work units.  One block
// a tile left two losses the wave model of the 132 SMs explains: the last,
// partial wave of a grid ran on few SMs (3.15 waves of work took 4 at
// 3,328 rows), and a 512-row chunk had too few 256-row tiles to fill the
// card, so it took 128-row blocks, which convert twice as often per flop.
// Now:
//   - persistent blocks.  The grid is as many blocks (clusters of `split`
//     blocks) as the card holds at once (cudaOccupancyMaxActiveClusters,
//     asked once per instantiation: `mc_w8a16_gemm_clusters`).  A block
//     walks its units, each a (tile, k range) pair, in the grouped raster
//     order (8 row tiles walked under each column tile, so the units in
//     flight share their weight columns and rows of x in L2).  The ring's
//     stages and mbarrier phases run on across units: the producer loads
//     the next unit's tiles while the consumers scale and store the last
//     one from registers, and the barriers are initialized once a block;
//   - K split inside a cluster where the wave model leaves SMs idle.  The
//     first `whole` tiles of the raster (whole waves) are whole units, one
//     block each.  Each tile after them is split along K into `split`
//     (2 or 4) contiguous ranges of 64-deep steps, one to each block of a
//     cluster (`cudaLaunchKernelEx` with the cluster attribute;
//     capturable): the ragged last wave of a large product, and every tile
//     of a product whose 256-row tiles cannot fill the card (a 512-row
//     chunk, the tp shards, 9-256 rows).  ops/quant.py `_k6_plan` picks the
//     rows, the split and `whole` by the least cost of the waves;
//   - the partial sums, in a fixed order, through distributed shared
//     memory.  Block o of a cluster owns rows [o/split, (o+1)/split) of a
//     split tile.  Once every block's ring is drained (a cluster barrier:
//     every product has retired, every producer waits), each block stores
//     its fp32 partial of block o's rows into slot `rank` of block o's
//     ring (the whole tile's partials take 128 KB of the 200 KB ring at 256
//     rows; a store into a peer goes out without waiting for it).  After a
//     second barrier each block adds its slots in rank order (k order),
//     scales and stores its rows, and only then lets its producer load
//     again (a named barrier), so no TMA write of the next unit lands on a
//     partial.  No global workspace, no atomics, no flag to reset: each
//     output is the same sum in the same order at every launch and every
//     graph replay.  A whole tile's output is one block's sum in k order,
//     the plain product's (cuBLAS's) bit for bit; a split tile's is the
//     split's partial sums added in k order, which moves it from that by
//     a share of max |y| that grows linearly with K (up to 3.2e-6 at split
//     2 and 4.0e-6 at split 4 at K = 4,096, 8.5e-6 and 1.12e-5 at 11,008),
//     so `_k6_plan` splits only K up to 6,144 and 4,608 (`_K6_SPLIT_MAX_K`:
//     half the 1e-5 the fp32 result is held to);
//   - the epilogue.  Each thread holds 2 consecutive weight columns of 2
//     of every 8 rows, so it scales them by its 2 scales and stores them
//     straight from registers (a warp's stores of a row 64 contiguous
//     bytes at fp32); rows past M and columns past N are not stored (TMA
//     filled them with zeros on load, as it fills K's tail).
//
// Measured on an H100 80GB HBM3 at 700 W (scripts/torch_kernel_ab.py --only
// K6, scripts/torch_k6_blocks.py; PERF.md): a round of whole 256-row units
// keeps ~719 TFLOP/s, a round of split units 573 (split 2) and 440 (4),
// the conversion ~9% of a whole unit's time.  A block keeps one set of
// accumulators, so the tensor cores still wait out each tile's epilogue:
// whole waves run as fast as one block a tile did; the split tail and the
// 256-row chunk are where the grid gains.
//
// Tests: on the CPU, tests/test_torch_k6.py holds `_k6_plan` and
// `_k6_schedule` (this file's `Units`, mirrored) to cover y once at every
// main-path shape and emulates the schedule's arithmetic (fp32 partials
// over each k range, added in rank order) against the JAX package's
// `dequant_matmul`; on the card, `python -m pytest --noconftest -m
// requires_cuda tests/test_torch_kernels_cuda.py -k k6` holds every
// (rows, split), forced, ragged M, N and K and fp16 x to the plain product
// (1e-5 at fp32, 2e-2 at bf16), and repeated launches and graph replays
// bit for bit.
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
constexpr int kConsumers = 256;
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 200 * 1024;  // of the 227 KB a block may have
constexpr int kMaxSplit = 4;    // blocks of a cluster that split one tile

enum OutType { kOutF32 = 0, kOutBF16 = 1, kOutF16 = 2 };

// A block of 128 weight columns (64 a consumer warpgroup) by kBM rows of x.
// A stage holds x [kBM][64] bf16 and q [64][128] int8, one TMA box each,
// 1024-aligned under the 128-byte swizzle.  A split tile's fp32 partial
// (16 bytes a consumer thread for each 8 rows) goes into the drained ring.
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
  static constexpr int kGroups = kBM / 8;  // 8-row groups: 4 fp32 a thread
  static_assert(kGroups * kConsumers * 16 <= kBars,
                "a split tile's partial must fit in the ring");
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

// A block's work units.  The grid is `clusters` clusters of `split` blocks
// (gridDim.x = clusters * split).  The tiles of y, numbered in the grouped
// raster order, are whole units while t < whole: block b takes t = b,
// b + gridDim.x, ...  Each later tile is split: cluster c takes t = whole
// + c, whole + c + clusters, ..., and its block of rank r the 64-deep steps
// [r n_k / split, (r + 1) n_k / split) of it.  ops/quant.py `_k6_schedule`
// mirrors this.
struct Units {
  int m_tiles, n_tiles, group, split, whole, n_k;
  int block, blocks, cluster, clusters, rank, n_whole, n_split;

  __device__ Units(int m_tiles_, int n_tiles_, int group_, int split_,
                   int whole_, int n_k_)
      : m_tiles(m_tiles_), n_tiles(n_tiles_), group(group_), split(split_),
        whole(whole_), n_k(n_k_) {
    block = blockIdx.x;
    blocks = gridDim.x;
    cluster = block / split;  // a cluster is `split` consecutive blocks
    clusters = blocks / split;
    rank = block % split;     // its block's rank in it (%cluster_ctarank)
    n_whole = whole > block ? (whole - block + blocks - 1) / blocks : 0;
    const int tail = m_tiles * n_tiles - whole;
    n_split = tail > cluster ? (tail - cluster + clusters - 1) / clusters : 0;
  }
  __device__ int count() const { return n_whole + n_split; }

  // Unit j: its tile's (row tile, column tile) and its steps [k0, k1);
  // whether it is a split unit.
  __device__ bool at(int j, int& mt, int& nt, int& k0, int& k1) const {
    int t;
    const bool split_unit = j >= n_whole;
    if (!split_unit) {
      t = block + j * blocks;
      k0 = 0;
      k1 = n_k;
    } else {
      t = whole + cluster + (j - n_whole) * clusters;
      k0 = rank * n_k / split;
      k1 = (rank + 1) * n_k / split;
    }
    // groups of `group` row tiles, the group's row tiles walked under each
    // column tile
    const int per_group = group * n_tiles;
    const int first = t / per_group * group;
    const int rows_here = min(m_tiles - first, group);
    const int r = t % per_group;
    mt = first + r % rows_here;
    nt = r / rows_here;
    return split_unit;
  }
};

template <typename T, int kBM>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tq,
                  const float* __restrict__ scale, void* __restrict__ out,
                  int out_type, int M, int N, int K, int m_tiles,
                  int n_tiles, int group, int split, int whole) {
  using C = Cfg<kBM>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned, indexed from smem_raw so that reads of it stay shared
  // loads (a pointer cast from an integer would make them generic)
  uint8_t* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t full0 = sbase + C::kBars;  // + 8 * stage
  const uint32_t empty0 = full0 + 8 * S;    // + 8 * stage
  const int tid = threadIdx.x;
  const Units units(m_tiles, n_tiles, group, split, whole,
                    (K + kBK - 1) / kBK);

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
    // Warp 0 walks the ring (lane 0 issues); every warp of the warpgroup
    // meets the cluster barriers of the split units.
    reg_dealloc<40>();
    const int warp = tid / 32, lane = tid % 32;
    if (tid == 0) {
      prefetch_tensormap(&tx);
      prefetch_tensormap(&tq);
    }
    int it = 0;  // the ring's step, across units
    for (int j = 0; j < units.count(); ++j) {
      int mt, nt, k0, k1;
      const bool split_unit = units.at(j, mt, nt, k0, k1);
      if (warp == 0) {
        for (int kt = k0; kt < k1; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
          if (lane == 0) {
            const uint32_t st = sbase + s * C::kStageBytes;
            mbar_arrive_expect_tx(full0 + 8 * s, C::kStageBytes);
            tma_load_3d(st, &tx, full0 + 8 * s, kt * kBK, mt * kBM, 0);
            tma_load_3d(st + C::kXBytes, &tq, full0 + 8 * s, nt * kBN,
                        kt * kBK, 0);
          }
          __syncwarp();
        }
      }
      // a split unit's partials fill the ring: nothing more is loaded
      // until the cluster has exchanged them and this block has summed its
      // rows (the consumers' barriers, below)
      if (split_unit) {
        cluster_sync();
        cluster_sync();
        bar_sync(2, kThreads);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int ct = tid - 128;      // 0 .. 255
    const int cw = ct / 128;       // which 64 weight columns of the tile
    const int t = ct % 128;
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
    // Step i of the unit that starts at the ring's step `base`.
    auto tile = [&](int base, int i, uint32_t(&cur)[16],
                    uint32_t(&prev)[16]) {
      const int s = (base + i) % S;
      mbar_wait(full0 + 8 * s, ((base + i) / S) & 1);
      convert(s, cur);
      wgmma_fence();
      issue(s, cur);
      wgmma_commit();
      if (i > 0) {
        wgmma_wait<1>();  // the previous step's products
        fence_words(prev);
        release((base + i - 1) % S);
      }
    };

    int it = 0;  // the ring's step, across units
    for (int j = 0; j < units.count(); ++j) {
      int mt, nt, k0, k1;
      const bool split_unit = units.at(j, mt, nt, k0, k1);
      const int n = k1 - k0;
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
      for (int i = 0; i < n; i += 2) {
        tile(it, i, a0, a1);
        if (i + 1 < n) tile(it, i + 1, a1, a0);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_words(a0);
      fence_words(a1);
      if (n > 0) release((it + n - 1) % S);
      it += n;

      // Thread (warp, g, t4) holds weight columns nb (A row g) and nb + 1
      // (row g + 8) of rows 8i + 2 t4 + e: acc[4i + e] and acc[4i + 2 + e].
      const int m0 = mt * kBM;
      const int nb = nt * kBN + col;
      const bool in_n = nb < N;  // N % 16 == 0: both columns in or out
      const float2 sc = in_n ? *reinterpret_cast<const float2*>(scale + nb)
                             : make_float2(0.f, 0.f);
      if (!split_unit) {
        // scaled, 8 bytes a row (fp32), a warp's stores of a row 64
        // contiguous bytes
        if (in_n) {
#pragma unroll
          for (int i = 0; i < C::kGroups; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = m0 + 8 * i + 2 * t4 + e;
              if (m < M)
                store2(out, out_type, (long)m * N + nb, acc[i * 4 + e] * sc.x,
                       acc[i * 4 + 2 + e] * sc.y);
            }
        }
        continue;
      }
      // A split unit.  Block `o` of the cluster sums the 8-row groups
      // [o G / split, (o + 1) G / split) (G / split of them, `per`).  Once
      // every block's ring is drained (the first barrier: every product of
      // the cluster has retired, every producer waits), each block writes
      // its partial of block o's groups into slot `rank` of block o's ring,
      // 16 bytes a thread a group (stores into a peer's shared memory go
      // out without waiting); after the second barrier each block reads
      // its own ring and adds the slots in rank order (k order).
      const int per = C::kGroups / split;
      cluster_sync();
#pragma unroll
      for (int i = 0; i < C::kGroups; ++i) {
        const int o = i / per;
        const uint32_t slot =
            sbase + ((units.rank * per + i % per) * kConsumers + ct) * 16;
        st_cluster_f4(mapa_shared(slot, o),
                      make_float4(acc[i * 4], acc[i * 4 + 1], acc[i * 4 + 2],
                                  acc[i * 4 + 3]));
      }
      cluster_sync();
      const int i0 = units.rank * per;
      for (int i = 0; i < per; ++i) {
        const float4* slots =
            reinterpret_cast<const float4*>(smem) + i * kConsumers + ct;
        float4 y = slots[0];
#pragma unroll
        for (int p = 1; p < kMaxSplit; ++p)
          if (p < split) {
            const float4 v = slots[p * per * kConsumers];
            y.x += v.x;
            y.y += v.y;
            y.z += v.z;
            y.w += v.w;
          }
        const int m = m0 + 8 * (i0 + i) + 2 * t4;
        if (in_n && m < M)
          store2(out, out_type, (long)m * N + nb, y.x * sc.x, y.z * sc.y);
        if (in_n && m + 1 < M)
          store2(out, out_type, (long)(m + 1) * N + nb, y.y * sc.x,
                 y.w * sc.y);
      }
      fence_proxy_async();      // these reads of the ring before TMA's next
      bar_sync(2, kThreads);    // writes: the producer loads again
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

// The kernel's shared memory, set once per instantiation (a thread-safe
// static), never inside a capture: the first call of each instantiation
// (the occupancy query, or an eager launch) sets it.
template <typename T, int kBM>
cudaError_t smem_attribute() {
  static const cudaError_t attribute = cudaFuncSetAttribute(
      w8a16_gemm_kernel<T, kBM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<kBM>::kAlloc);
  return attribute;
}

// Clusters of `split` blocks the card runs at once; negative: a CUDA error.
template <typename T, int kBM>
int active_clusters(int split) {
  const cudaError_t attribute = smem_attribute<T, kBM>();
  if (attribute != cudaSuccess) return -static_cast<int>(attribute);
  if (split == 1) {  // plain blocks: those an SM holds, on every SM
    int per_sm = 0, device = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, w8a16_gemm_kernel<T, kBM>, kThreads, Cfg<kBM>::kAlloc);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(split);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = Cfg<kBM>::kAlloc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, w8a16_gemm_kernel<T, kBM>, &config);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, int kBM>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out,
                   int out_type, int M, int K, int N, int group, int split,
                   int clusters, int whole, cudaStream_t stream) {
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
  const cudaError_t attribute = smem_attribute<T, kBM>();
  if (attribute != cudaSuccess) return attribute;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * split);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = Cfg<kBM>::kAlloc;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = split > 1 ? 1 : 0;  // whole tiles only: plain blocks
  const cudaError_t err = cudaLaunchKernelEx(
      &config, w8a16_gemm_kernel<T, kBM>, tx, tq,
      static_cast<const float*>(scale), out, out_type, M, N, K, m_tiles,
      n_tiles, group, split, whole);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int rows, const void* x, const void* q,
                     const void* scale, void* out, int out_type, int M, int K,
                     int N, int group, int split, int clusters, int whole,
                     cudaStream_t st) {
  switch (rows) {
    case 64:
      return launch<T, 64>(x, q, scale, out, out_type, M, K, N, group, split,
                           clusters, whole, st);
    case 128:
      return launch<T, 128>(x, q, scale, out, out_type, M, K, N, group,
                            split, clusters, whole, st);
    case 256:
      return launch<T, 256>(x, q, scale, out, out_type, M, K, N, group,
                            split, clusters, whole, st);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool valid_rows(int rows) { return rows == 64 || rows == 128 || rows == 256; }
bool valid_split(int split) { return split == 1 || split == 2 || split == 4; }

}  // namespace

// y = (x @ q) * scale over tiles of 128 weight columns by `rows` (64, 128
// or 256) rows of x, `group` row tiles a raster group, by `clusters`
// persistent clusters of `split` (1, 2 or 4) blocks: the first `whole`
// tiles one block each, the rest split along K over a cluster's blocks
// (ops/quant.py `_k6_plan`).  Returns cudaErrorInvalidValue, launching
// nothing, for other rows or splits, for K % 8 or N % 16 != 0, for pointers
// that are not 16-byte aligned, and for a schedule the plan cannot make: a
// split of 1 with a tile not whole, a split with no tile to split, whole
// tiles that are not whole waves of the grid, or more blocks of a cluster
// than 64-deep steps.
extern "C" int mc_w8a16_gemm(const void* x, const void* q, const void* scale,
                             void* out, int M, int K, int N, int rows,
                             int group, int split, int clusters, int whole,
                             int x_bf16, int out_type, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      group <= 0 || !valid_rows(rows) || !valid_split(split) ||
      clusters <= 0 || out_type < kOutF32 || out_type > kOutF16 ||
      !aligned16(x) || !aligned16(q) || !aligned16(scale) || !aligned16(out))
    return cudaErrorInvalidValue;
  const long tiles = long((M + rows - 1) / rows) * ((N + kBN - 1) / kBN);
  const int n_k = (K + kBK - 1) / kBK;
  if (whole < 0 || whole > tiles ||
      (split == 1 && whole != tiles) ||
      (split > 1 && (whole == tiles || whole % (clusters * split) != 0 ||
                     n_k < split)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(rows, x, q, scale, out, out_type, M, K, N,
                                   group, split, clusters, whole, st);
  return dispatch<__half>(rows, x, q, scale, out, out_type, M, K, N, group,
                          split, clusters, whole, st);
}

// Clusters of `split` blocks of `rows` rows that the card runs at once
// (cudaOccupancyMaxActiveClusters; the smaller of the bf16 and fp16
// instantiations', whose shared memory it sets); -1 for rows or a split
// K6 does not take, minus the CUDA error where the query fails.
extern "C" int mc_w8a16_gemm_clusters(int rows, int split) {
  if (!valid_rows(rows) || !valid_split(split)) return -1;
  int bf16 = -1, f16 = -1;
  switch (rows) {
    case 64:
      bf16 = active_clusters<__nv_bfloat16, 64>(split);
      f16 = active_clusters<__half, 64>(split);
      break;
    case 128:
      bf16 = active_clusters<__nv_bfloat16, 128>(split);
      f16 = active_clusters<__half, 128>(split);
      break;
    case 256:
      bf16 = active_clusters<__nv_bfloat16, 256>(split);
      f16 = active_clusters<__half, 256>(split);
      break;
  }
  if (bf16 < 0) return bf16;
  if (f16 < 0) return f16;
  return bf16 < f16 ? bf16 : f16;
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
