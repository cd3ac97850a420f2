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
// read once and does 2 * M flops (at most 16 a byte, far under the ~295 the
// tensor cores need a byte), so the least time is the weight's bytes over
// 3.35 TB/s: 5.0 us for a 4096 x 4096 matrix.  Three things stand between a
// kernel and that bound, and the design answers each:
//   - the instruction rate at several rows.  Scalar fp32 FMAs cost M a
//     weight byte, ~10 instructions a byte with the convert at M = 8: more
//     than the 132 SMs issue at 3.35 TB/s.  At 2-8 rows the products run on
//     the tensor cores, `mma.sync.m16n8k16` with fp32 accumulators, on the
//     transposed product y^T[n, m] = sum_k q^T[n, k] x^T[k, m]: 16 weight
//     columns are the 16-row A operand, x's rows (zero past M) the 8-wide B
//     operand, so one warp instruction does 16 columns x 16 k x 8 rows
//     whatever M is.  The int8 A fragment becomes bf16 in registers,
//     exactly (|q| <= 127), by a byte permute, two masks and one packed add
//     (two bf16 values that sum to q: 128 + (q & 127), and -128 or -256 by
//     q's sign bit); fp16 activations take the f16 mma and a magic-number
//     subtract.  About 2.3 instructions a weight byte at every M.
//   - the weight stream.  TMA copies [rows][<= 128 B] boxes of q, in its
//     [K, N] layout, into a ring of 4 stages of 8 KB with mbarriers, fed by
//     one producer warp; 8 consumer warps each take a 16-row k-step of 64
//     columns from every stage, read their A words from shared memory (the
//     transpose the fragment needs) and release the slot once the words are
//     converted.  How fast a column tile streams grows with its width (long
//     runs of each weight row): on the H100, the lm_head at two rows
//     streams at 1.67, 1.97 and 2.28 TB/s with tiles of 64, 128 and 256
//     columns (scripts/torch_kernel_ab.py --only K5).
//   - the split-K tail.  A narrow tile lets the grid fill the 132 SMs with
//     few K splits, so the partials are small; a wide one streams faster.
//     The caller's rule (ops/quant.py `_k5_plan`) picks the tile (64, 128
//     or 256 columns) and the split count for each (M, K, N): at 8 rows the
//     fp32 partials stay under 1/8 of the weight's bytes and the last block
//     of a tile reads at most 32 KB of them.  The combine: each split
//     writes its partial and bumps a counter of its column tile, the last
//     block adds the partials in split order (deterministic: no float
//     atomics) and resets the counter, so a product is one launch and a
//     graph replay gives the eager call's bits.
// At one row, and at two where the caller's cost says so, the streaming
// kernel below runs instead: 512 contiguous bytes a warp and row stream
// faster than the ring's 128-byte boxes, and at 1-2 rows the FMAs need no
// tensor core.  It also takes up to three weights that share x in one
// launch (q/k/v, gate/up).
// At 1-2 rows the streaming kernel also takes the decode layer's
// elementwise work around a product group into the same launch (kernels
// K8 and K9 of decode_fused.cu, which otherwise run as launches of their
// own, each ~2 us of fixed cost for a few kilobytes): mc_w8a16_gemv_norm.
//   - K8 in the prologue (kProNorm): every block reads the whole row(s) of x
//     and of the residual y (16 KB a row at Vicuna-7B's 4,096, from L2)
//     after issuing its first weight loads and its first batch's x, y and
//     w, so the norm runs under the stream's ramp; it sums the squares in
//     K8's own thread and warp order (decode_norm.cuh: 256 threads, the
//     same 16-byte vectors) for each row's r, one block barrier, and the
//     loop then forms each element of h it multiplies from x, y and w
//     (loaded a batch ahead, as x is), so the products see K8's h bit for
//     bit.  Block (0, 0) writes the new residual stream s = x + y (out of
//     place) and, where an adapter branch needs it, h.
//   - K9 in the epilogue (kRopeD 64 or 128, the q/k/v group with its
//     products rounded to the activations' type): the block that holds a
//     tile's final sums rotates q's and k's heads (a rotate-half partner is
//     in the same warp, D / 32 lanes away, at the same column pair: one
//     shuffle) with K9's roundings, stores q rotated, and quantizes k and
//     v per head vector (the amax by shuffles over the head's lanes, then
//     over the 8 warps through shared memory) into the cache slot read from
//     device memory, or stores them in T: k and v never reach device memory
//     but in the cache.
//   - K10 in the prologue (kProSilu, the down product): each lane loads
//     the bits of gate and up for its own element of x a batch ahead (in
//     place of x) and forms h = T(T(silu(gate)) * up) with K10's
//     roundings (decode_silu.cuh); no row reduction, no barrier, each block
//     reads only the K range it streams.  Where an adapter branch needs h,
//     the blocks of the first column tile write the elements they form
//     (each split its K range); otherwise h never reaches device memory.
// All three are bit-equal to K8, K10, this kernel and K9 launched in turn.
//
// The A fragment pairs two k of one column, while q is [K, N] with N
// contiguous: thread (g, t) of a warp reads 8 bytes (8 columns) from each of
// rows t, t + 4, t + 8, t + 12 of its k-step, and those four rows are the
// four k slots (2t, 2t + 1, 2t + 8, 2t + 9) of its fragment; each of its 8
// columns is an A row of one of the four mma tiles.  B uses the same k
// order: x is staged once a block in shared memory as bf16/fp16 already in
// fragment order (one 8-byte read a k-step).  The swizzle of the TMA box
// and the column group given to each g keep a half-warp's 8-byte reads on
// distinct banks (64-column tiles) or at most two deep (wider ones).
//
// Layouts: x [M, K] bf16 or fp16 with row stride ldx (elements); q [K, N]
// int8 row-major, N % 16 == 0, 16-byte aligned; scale [N] fp32; part fp32
// and counters uint32, one a column tile, zero between launches (used only
// when K is split); out [M, N] fp32, bf16 or fp16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "decode_norm.cuh"
#include "decode_silu.cuh"
#include "hopper.cuh"

namespace {

using hopper::cvt_pair;
using hopper::fence_barrier_init;
using hopper::fence_proxy_async;
using hopper::make_map_3d;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;
using hopper::tma_load_3d;

constexpr int kStep = 16;                    // K rows of one mma
constexpr int kGroup = 64;                   // columns a warp covers
constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + one producer warp
constexpr int kStageBytes = 8192;            // one stage of the ring
constexpr int kStages = 4;        // ring depth
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxRows = 2048;               // K rows a block
constexpr int kMaxM = 8;

enum OutType { kOutF32 = 0, kOutBF16 = 1, kOutF16 = 2 };

// The layout of a stage for a column tile of kTile int8 columns: kTile / 64
// groups of 64 columns, each group's columns read by kSteps warps, one
// 16-row k-step each, so a stage is kSteps * 16 rows deep; TMA boxes of at
// most 128 bytes a row (the widest swizzle), kBoxes of them side by side.
template <int kTile>
struct Stage {
  static constexpr int kGroups = kTile / kGroup;
  static constexpr int kSteps = kWarps / kGroups;
  static constexpr int kRows = kSteps * kStep;
  static constexpr int kBox = kTile < 128 ? kTile : 128;
  static constexpr int kBoxes = kTile / kBox;
  static constexpr int kRedStride = kTile + 4;  // floats a row of the sums
  static_assert(kRows * kTile == kStageBytes, "a stage is 8 KB");
};

// Bytes of x's fragments for `rows` K rows: 32 lanes x 8 bytes a k-step.
__host__ __device__ constexpr int x_frag_bytes(int rows) {
  return (rows + kStep - 1) / kStep * 32 * 8;
}

// Dynamic shared memory of a block: the ring (1024-aligned), x's
// fragments, the full and empty barriers, and the slack to align.
__host__ __device__ constexpr int smem_bytes(int rows) {
  return 1024 + kRingBytes + x_frag_bytes(rows) + 2 * kStages * 8 + 16;
}

// The 8-byte column group (of a warp's eight) read by A-row group g: the
// groups of g and g ^ 1 share a 16-byte chunk, and the chunks of g = 0..3
// (and of 4..7) are {0, 2} (and {1, 3}), so under the 64-byte swizzle a
// half-warp's reads of its 4 rows meet no bank twice (under the 128-byte
// swizzle, twice at most).
__device__ __forceinline__ int col_group(int g) {
  return ((g & 2) << 1) | ((g & 4) >> 1) | (g & 1);  // 0 1 4 5 2 3 6 7
}

// Byte offset of (row, byte col) in a stage of kBoxes [kRows][kBox] boxes
// written by TMA with the kBox-byte swizzle from a 1024-aligned base: the
// 16-byte chunk index is XORed with bits 1-2 (64 B) or 0-2 (128 B) of the
// row.
template <int kTile>
__device__ __forceinline__ int stage_offset(int row, int col) {
  using S = Stage<kTile>;
  const int box = col / S::kBox, c = col % S::kBox;
  const int chunk = S::kBox == 64 ? ((c >> 4) ^ (row >> 1)) & 3
                                  : ((c >> 4) ^ row) & 7;
  return box * S::kRows * S::kBox + row * S::kBox + (chunk << 4) + (c & 15);
}

// D[16 x 8] += A[16 x 16] B[16 x 8], fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// x's rows [k0, k0 + n) into fragment order: element (m, k0 + 16s + 4j + t)
// at half-word (32s + 4m + t) * 4 + j, so lane 4m + t reads its B fragment
// {b0, b1} of k-step s as one 8-byte word.  Rows m >= M and k past n are
// zero.  Reads are coalesced along K, 8 elements a thread where `vec`.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, int ldx,
                                        int vec, int M, int k0, int n,
                                        int n_steps, uint16_t* sx, int tid) {
  const int width = n_steps * kStep;  // K rows staged, n rounded up
  const int chunks = width / 8;
  for (int i = tid; i < kMaxM * chunks; i += kWarps * 32) {
    const int m = i / chunks, kl = (i - m * chunks) * 8;
    uint16_t e[8];
    if (m < M && vec && kl + 8 <= n) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          x + (long)m * ldx + k0 + kl));
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        e[2 * c] = static_cast<uint16_t>(ws[c] & 0xFFFFu);
        e[2 * c + 1] = static_cast<uint16_t>(ws[c] >> 16);
      }
    } else {
      const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        e[c] = m < M && kl + c < n ? xs[(long)m * ldx + k0 + kl + c] : 0;
    }
    const int s = kl / kStep, r = kl % kStep;  // r is 0 or 8
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = (r + c) >> 2, t = (r + c) & 3;
      sx[(s * 32 + 4 * m + t) * 4 + j] = e[c];
    }
  }
}

// One or two rows of x (batch-1 decode, the vision pair): the streaming
// kernel.  A warp reads 512 contiguous bytes of a weight row (16 int8
// columns a thread, one 16-byte load), so a block of 8 warps owns a
// 512-column tile and splits its K range into 8 runs of rows, one a warp.
// Each launch pays a fixed cost besides its stream (scripts/
// torch_kernel_ab.py --only K5 took it apart on the first one-row kernel
// at 4096 x 4096: 1.2 us of launch, 0.4 of x staged before the first
// weight load, 2.3 of split combine, ~1.2 of the stream's ramp), and at
// 4096 x 4096 the stream itself is only ~5.5 us.  So:
//   - weights first: a warp issues its first 8 row loads (16 bytes a
//     thread each, `ld.global.nc` with a 256-byte L2 prefetch) before it
//     reads x, and x is read into registers (lane l of a warp holds row
//     l / 8 of x at the batch's (l % 8)-th row, broadcast by a shuffle),
//     never through shared memory behind a barrier;
//   - a ring of 8 loads in flight a thread: each row consumed is replaced
//     by the load of the row 8 further on, and the next batch's x is read
//     while this batch's rows land (8 in flight streamed faster than 16 on
//     the H100, two blocks an SM);
//   - a short combine: the 8 warps' sums meet in shared memory once; the
//     split partials lie in thread order (coalesced); one thread a block
//     bumps the tile's counter with release-acquire semantics (no fence a
//     thread: 0.5 us less); the last block of a tile reads the partials
//     with 16 loads in flight a thread and adds them in split order
//     (deterministic: no float atomics); the caller's rule (ops/quant.py
//     `_stream_plan`) bounds how many there are;
//   - one launch for up to three products that share x (q/k/v, gate/up):
//     the grid's column tiles run over every member's, each member with
//     its own weight, scale and output, so the group pays the fixed cost
//     once and the narrow products fill the card beside the others.
// int8 becomes fp32 by a byte permute and an add (`hopper::cvt4`), then M
// fp32 FMAs a weight: about 3 instructions a weight byte at two rows,
// within what the SMs issue at the card's memory rate.
constexpr int kSCols = 16;                 // int8 columns a thread
constexpr int kSTile = 32 * kSCols;        // 512 columns a block
constexpr int kSBatch = 8;                 // row loads a thread keeps in flight
constexpr int kSPartLoads = 16;            // partial loads of the combine
constexpr int kSWarps = 8;
constexpr int kSThreads = kSWarps * 32;
constexpr int kSMaxM = 2;
constexpr int kMaxMembers = 3;
constexpr int kSNormMaxK = decode_norm::kMaxH;  // K of a normed x: 8,192
static_assert(kSThreads == decode_norm::kThreads,
              "the norm prologue sums squares in K8's thread order");

// What the block that holds a member's final sums does with them: store
// them (every product), or, in the RoPE epilogue, rotate q's and store
// them, rotate k's and write them to the cache, write v's to the cache.
enum Role { kStore = 0, kRopeQ = 1, kRopeK = 2, kCacheV = 3 };

// One product of a group: its weight, scales, output [M, N], columns, the
// first column tile of the grid that is its, and its role.
struct StreamMember {
  const int8_t* q;
  const float* scale;
  void* out;
  int N;
  int tile0;
  int role;
};

struct StreamGroup {
  StreamMember m[kMaxMembers];
  int n;
};

// What the stream's prologue does to x before the products read it:
// nothing, K8's norm, or K10's SiLU product.
enum Prologue { kProNone = 0, kProNorm = 1, kProSilu = 2 };

// The prologue's operands.  The norm (kernel K8 folded in): x is then the
// residual stream [M, K] (contiguous rows), and the products read
// h = T(w * T(s * r)) of s = T(x + y) (or x where y is null).  The SiLU
// product (kernel K10 folded in): x is gate and y up, both [M, K]
// (contiguous rows), and the products read h = T(T(silu(x)) * y); w, sum
// and eps are unused.
struct NormArgs {
  const uint16_t* y;  // the residual to add [M, K] (or null), or up
  const uint16_t* w;  // the norm's weight [K]
  uint16_t* sum;      // s [M, K] where y is given: written by block (0, 0)
  uint16_t* h;        // h [M, K], or null: the norm's written by block
                      // (0, 0), the SiLU product's by the first column
                      // tile's blocks
  float eps;
};

// The RoPE + KV-cache epilogue's operands (kernel K9 folded in): cos and
// sin [M, D] fp32; the layer-stacked caches [NL, M, S, Hkv, D], int8 with
// fp32 scales [NL, M, S, Hkv, 1] (scale_k non-null) or T; the token's
// position of each row, int32 or int64 (pos64), read on the card.
struct RopeArgs {
  const float* cos;
  const float* sin;
  void* cache_k;
  void* cache_v;
  float* scale_k;
  float* scale_v;
  const void* pos;
  int pos64;
  int S, Hkv, layer;
};

// 16 int8 weights, read once: not kept in L1, a 256-byte L2 prefetch.
__device__ __forceinline__ uint4 ld_weights(const int8_t* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <typename T>
__device__ __forceinline__ float half_bits_to_float(uint16_t h) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  else
    return __half2float(__ushort_as_half(h));
}

// The norm prologue (kProNorm): kernel K8's arithmetic (decode_norm.cuh) in
// K8's thread order.  Each block reads the whole row(s) of x (and y), forms
// s = T(x + y), sums each row's squares as K8 does (thread t the 16-byte
// vectors t, t + 256, ...; the warps' shuffles; the 8 warps in order) and
// returns r = rsqrt(mean + eps) of each row; the stream loop forms each
// element of h = T(w * T(s * r)) it multiplies from that element's x, y
// and w (decode_norm::norm_at), so the products see K8's h bit for bit.
// Block (0, 0) also writes s (where y is given) and, where asked, h, out of
// place: the other blocks are still reading x.  The caller has issued the
// block's first weight loads and its first batch's x, y and w, so this
// runs under the stream's ramp.
template <typename T, int kM>
__device__ __forceinline__ void norm_prologue(const uint16_t* __restrict__ x,
                                              int K, const NormArgs& na,
                                              float (&r)[kM], int tid) {
  namespace dn = decode_norm;
  __shared__ float sSq[kM][kSWarps];
  const int nv = K / 8;
  const bool first = blockIdx.x == 0 && blockIdx.y == 0;
  auto s_at = [&](int m, int v) {  // T(x + y) (or x) of vector v of row m
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + (long)m * K) + v);
    return na.y == nullptr
               ? a
               : dn::add8<T>(a, __ldg(reinterpret_cast<const uint4*>(
                                          na.y + (long)m * K) + v));
  };
  float ss[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) ss[m] = 0.f;
#pragma unroll
  for (int u = 0; u < dn::kVecs; ++u) {
    const int v = tid + u * kSThreads;
    if (v >= nv) break;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const uint4 s = s_at(m, v);
      if (first && na.y != nullptr)
        reinterpret_cast<uint4*>(na.sum + (long)m * K)[v] = s;
      ss[m] = dn::sum_squares8<T>(s, ss[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    ss[m] = dn::warp_sum(ss[m]);
    if (tid % 32 == 0) sSq[m][tid / 32] = ss[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kM; ++m) r[m] = dn::rms_rsqrt(sSq[m], K, na.eps);
  if (!first || na.h == nullptr) return;
  // h for an adapter branch (block (0, 0) alone; the rows again from L2)
#pragma unroll
  for (int u = 0; u < dn::kVecs; ++u) {
    const int v = tid + u * kSThreads;
    if (v >= nv) break;
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(na.w) + v);
#pragma unroll
    for (int m = 0; m < kM; ++m)
      reinterpret_cast<uint4*>(na.h + (long)m * K)[v] =
          dn::norm8<T>(s_at(m, v), wv, r[m]);
  }
}

// The RoPE + KV-cache epilogue (kernel K9's work) on a q, k or v member's
// final sums v (unscaled) of columns own, own + 1 of every row, in the block
// that holds them.  The products are first rounded to T as K5's store
// rounds them; a head of D columns lies in one 512-column tile (a member's
// N is a multiple of D), over D / 16 neighbouring lanes of every warp, so a
// rotate-half partner (D / 2 columns away) is in the same warp, D / 32
// lanes away, at the same pair of columns: one shuffle.  The rotation is
// K9's `__fmul_rn` / `__fadd_rn` sequence; q is stored rotated; k (rotated)
// and v are quantized per head vector (the amax over the head's lanes by
// shuffles, then over the 8 warps through shared memory; K9's scale and
// `rintf(v / scale)`) into an int8 cache, or stored in T, at the row's
// slot [layer, m, pos[m], head].  Block-uniform: every thread calls it.
template <typename T, int kM, int D>
__device__ __forceinline__ void rope_epilogue(const StreamMember& mem,
                                              const float2 (&v)[kM],
                                              float2 sc, int own, bool mine,
                                              const RopeArgs& ra,
                                              float* sAmax, int warp,
                                              int lane) {
  namespace dn = decode_norm;
  constexpr int kHeadLanes = D / kSCols;  // 8 (D 128) or 4 (D 64)
  constexpr int kHalf = D / 2;
  const int j = own % D;  // the thread's first column within its head
  float a[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    a[m][0] = dn::round_t<T>(v[m].x * sc.x);
    a[m][1] = dn::round_t<T>(v[m].y * sc.y);
  }
  if (mem.role != kCacheV) {
    // q * cos + rotate_half(q) * sin, rotate_half(q) = [-q2, q1]
    const bool lo = j < kHalf;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float* c = ra.cos + m * D + j;
      const float* sn = ra.sin + m * D + j;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = __shfl_xor_sync(0xffffffffu, a[m][e], kHeadLanes / 2);
        const float rot =
            lo ? __fadd_rn(__fmul_rn(a[m][e], __ldg(c + e)),
                           __fmul_rn(-p, __ldg(sn + e)))
               : __fadd_rn(__fmul_rn(a[m][e], __ldg(c + e)),
                           __fmul_rn(p, __ldg(sn + e)));
        a[m][e] = dn::round_t<T>(rot);
      }
    }
  }
  if (mem.role == kRopeQ) {
    if (mine)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(mem.out) +
                                     (long)m * mem.N + own) =
            dn::pack2<T>(a[m][0], a[m][1]);
    return;
  }
  const bool int8 = ra.scale_k != nullptr;
  const bool is_k = mem.role == kRopeK;
  float scale[kM];
  if (int8) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float am = fmaxf(fabsf(a[m][0]), fabsf(a[m][1]));
#pragma unroll
      for (int o = 1; o < kHeadLanes; o <<= 1)
        am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
      sAmax[(m * kSWarps + warp) * 32 + lane] = am;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float am = 0.f;
#pragma unroll
      for (int w = 0; w < kSWarps; ++w)
        am = fmaxf(am, sAmax[(m * kSWarps + w) * 32 + lane]);
      // clamp_min(amax / 127.0, 1e-8), as K9 computes it
      scale[m] = fmaxf(__fmul_rn(am, 1.0f / 127.0f), static_cast<float>(1e-8));
    }
  }
  if (!mine) return;
  const int head = own / D;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const long p = ra.pos64 ? static_cast<const long long*>(ra.pos)[m]
                            : static_cast<const int*>(ra.pos)[m];
    if (p < 0 || p >= ra.S) continue;  // no slot: the wrapper's are < S
    const long slot =
        ((static_cast<long>(ra.layer) * kM + m) * ra.S + p) * ra.Hkv + head;
    void* cache = is_k ? ra.cache_k : ra.cache_v;
    if (int8) {
      char2 q2;
      q2.x = static_cast<signed char>(
          fminf(fmaxf(rintf(a[m][0] / scale[m]), -127.f), 127.f));
      q2.y = static_cast<signed char>(
          fminf(fmaxf(rintf(a[m][1] / scale[m]), -127.f), 127.f));
      *reinterpret_cast<char2*>(static_cast<int8_t*>(cache) + slot * D + j) =
          q2;
      if (j == 0) (is_k ? ra.scale_k : ra.scale_v)[slot] = scale[m];
    } else {
      *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(cache) + slot * D +
                                   j) = dn::pack2<T>(a[m][0], a[m][1]);
    }
  }
}

// kPro: the prologue (kProNorm, the norm prologue above: K8 folded into the
// launch that reads its output; kProSilu, K10 folded into the down
// product); kRopeD (64 or 128, else 0): the RoPE + KV-cache epilogue for
// the members whose role asks for it (K9 folded into the q/k/v launch).
template <typename T, int kM, int kPro, int kRopeD>
__global__ void __launch_bounds__(kSThreads, 2)
dequant_gemv_stream_kernel(const StreamGroup g, const uint16_t* __restrict__ x,
                           int ldx, int K, int rows, float* __restrict__ part,
                           unsigned* __restrict__ counters, int out_type,
                           const NormArgs na, const RopeArgs ra) {
  __shared__ float4 sRed[kSWarps * kM * 4 * 32];  // 16 KB a row of x
  __shared__ float sAmax[kRopeD > 0 ? kM * kSWarps * 32 : 1];
  __shared__ int sLast;

  const int t = blockIdx.x;  // the grid's column tile, over every member
  StreamMember mem = g.m[0];
  if (g.n > 1 && t >= g.m[1].tile0) mem = g.m[1];
  if (g.n > 2 && t >= g.m[2].tile0) mem = g.m[2];
  const int N = mem.N, tile = t - mem.tile0;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int k0 = split * rows;
  const int n = min(rows, K - k0);  // > 0: the host makes ceil(K / rows)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per_warp = rows / kSWarps;
  const int r0 = warp * per_warp;               // the warp's first row
  const int nw = max(0, min(per_warp, n - r0));  // and its row count
  const int col = tile * kSTile + lane * kSCols;
  const bool live = col < N;  // N % 16 == 0: all 16 columns in or out
  const int8_t* qp = mem.q + (long)(k0 + r0) * N + col;

  // The weights first: the first batch of rows is in flight before x is
  // read.
  uint4 w[kSBatch];
#pragma unroll
  for (int u = 0; u < kSBatch; ++u)
    w[u] = live && u < nw ? ld_weights(qp + (long)u * N)
                          : make_uint4(0u, 0u, 0u, 0u);

  // x of batch b: lane l holds row l / 16 of x at the batch's row l % 16.
  const int xm = lane / kSBatch, xu = lane % kSBatch;
  const uint16_t* xp = x + (long)xm * ldx + k0 + r0 + xu;
  auto x_of = [&](int b) {
    const int r = b * kSBatch + xu;
    return xm < kM && r < nw ? half_bits_to_float<T>(__ldg(xp + b * kSBatch))
                             : 0.f;
  };
  // With a prologue, the lane's element of h comes from the bits of x and
  // y (x | y << 16) and, for the norm, of w, loaded a batch ahead as x is
  // (zero past the rows), and for the norm its row's r.
  const uint16_t* yp = kPro == kProNone || na.y == nullptr
                           ? nullptr
                           : na.y + (long)xm * ldx + k0 + r0 + xu;
  const uint16_t* wp = kPro == kProNorm ? na.w + k0 + r0 + xu : nullptr;
  auto raw_of = [&](int b) {
    const int r = b * kSBatch + xu;
    uint2 v = make_uint2(0u, 0u);
    if (xm < kM && r < nw) {
      v.x = __ldg(xp + b * kSBatch);
      if (yp != nullptr)
        v.x |= static_cast<uint32_t>(__ldg(yp + b * kSBatch)) << 16;
      if constexpr (kPro == kProNorm) v.y = __ldg(wp + b * kSBatch);
    }
    return v;
  };
  float rr = 0.f;
  auto h_of = [&](uint2 v) {
    if constexpr (kPro == kProSilu)
      return decode_silu::silu_mul_at<T>(v.x);
    else
      return decode_norm::norm_at<T>(v, yp != nullptr, rr);
  };
  // The SiLU product's h for an adapter branch: the first column tile's
  // blocks write the elements of their K range as they form them.
  uint16_t* hp = kPro == kProSilu && na.h != nullptr && t == 0
                     ? na.h + (long)xm * ldx + k0 + r0 + xu
                     : nullptr;
  auto keep_h = [&](int b, float v) {
    if (hp != nullptr && xm < kM && b * kSBatch + xu < nw)
      hp[b * kSBatch] = static_cast<uint16_t>(decode_norm::pack2<T>(v, 0.f));
  };
  float xr;
  if constexpr (kPro == kProNorm) {
    const uint2 raw = raw_of(0);
    float r[kM];
    norm_prologue<T, kM>(x, K, na, r, tid);
    rr = xm == 0 ? r[0] : r[kM - 1];
    xr = h_of(raw);
  } else if constexpr (kPro == kProSilu) {
    xr = h_of(raw_of(0));
    keep_h(0, xr);
  } else {
    xr = x_of(0);
  }

  // The thread's two output columns of the combine below, and their scales.
  const int own = tile * kSTile + lane * kSCols + 2 * warp;
  const bool mine = own < N;
  const float2 sc = mine ? __ldg(reinterpret_cast<const float2*>(mem.scale +
                                                                own))
                         : make_float2(0.f, 0.f);

  float acc[kM][kSCols];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int c = 0; c < kSCols; ++c) acc[m][c] = 0.f;
  for (int b = 0; b * kSBatch < nw; ++b) {
    // the next batch's x (or its raw operands), in flight now
    [[maybe_unused]] float xn = 0.f;
    [[maybe_unused]] uint2 rn = make_uint2(0u, 0u);
    if constexpr (kPro != kProNone)
      rn = raw_of(b + 1);
    else
      xn = x_of(b + 1);
#pragma unroll
    for (int u = 0; u < kSBatch; ++u) {
      const int r = b * kSBatch + u;
      if (r < nw) {  // warp-uniform
        float xv[kM];
#pragma unroll
        for (int m = 0; m < kM; ++m)
          xv[m] = __shfl_sync(0xffffffffu, xr, m * kSBatch + u);
        const uint32_t ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          float wf[4];
          hopper::cvt4(ws[c4], wf);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int m = 0; m < kM; ++m)
              acc[m][4 * c4 + e] = fmaf(xv[m], wf[e], acc[m][4 * c4 + e]);
        }
      }
      // the slot takes the row kSBatch further on
      w[u] = live && r + kSBatch < nw
                 ? ld_weights(qp + (long)(r + kSBatch) * N)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (kPro != kProNone) {
      xr = h_of(rn);
      if constexpr (kPro == kProSilu) keep_h(b + 1, xr);
    } else {
      xr = xn;
    }
  }

  // The warps' sums meet once in shared memory, [warp][m][c4][lane] as
  // float4; thread (warp j, lane l) then adds, over the 8 warps, columns
  // 2j and 2j + 1 of lane l's 16.
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
      sRed[((warp * kM + m) * 4 + c4) * 32 + lane] =
          make_float4(acc[m][4 * c4], acc[m][4 * c4 + 1], acc[m][4 * c4 + 2],
                      acc[m][4 * c4 + 3]);
  __syncthreads();
  float2 s[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    s[m] = make_float2(0.f, 0.f);
#pragma unroll
    for (int v = 0; v < kSWarps; ++v) {
      const float2 p = reinterpret_cast<const float2*>(
          &sRed[((v * kM + m) * 4 + warp / 2) * 32 + lane])[warp % 2];
      s[m].x += p.x;
      s[m].y += p.y;
    }
  }
  // The final sums of the tile's columns, scaled and stored (or, for a
  // member of the RoPE epilogue, taken on by it).
  auto finish = [&](const float2 (&y)[kM]) {
    if constexpr (kRopeD > 0) {
      if (mem.role != kStore) {
        rope_epilogue<T, kM, kRopeD>(mem, y, sc, own, mine, ra, sAmax, warp,
                                     lane);
        return;
      }
    }
    if (mine)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        store2(mem.out, out_type, (long)m * N + own, y[m].x * sc.x,
               y[m].y * sc.y);
  };
  if (n_splits == 1) {
    finish(s);
    return;
  }

  // Split K: the partials [tile][split][m] of 256 float2 in thread order;
  // the last block of the tile to finish adds them all, in split order.
  // One thread bumps the tile's counter with release and acquire
  // semantics at gpu scope, between two block barriers: the release
  // publishes every thread's partials (ordered before it by the barrier),
  // the acquire makes the other blocks' visible to the last block, so no
  // thread needs a fence of its own.
  float2* tile_part = reinterpret_cast<float2*>(part) +
                      (long)t * n_splits * kM * (kSThreads) + tid;
#pragma unroll
  for (int m = 0; m < kM; ++m)
    tile_part[(split * kM + m) * kSThreads] = s[m];
  __syncthreads();
  if (tid == 0) {
    unsigned done;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(done)
                 : "l"(counters + t)
                 : "memory");
    sLast = done == static_cast<unsigned>(n_splits - 1);
  }
  __syncthreads();
  if (!sLast) return;
  float2 tot[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) tot[m] = make_float2(0.f, 0.f);
  for (int s0 = 0; s0 < n_splits; s0 += kSPartLoads) {
    float2 v[kSPartLoads][kM];
#pragma unroll
    for (int u = 0; u < kSPartLoads; ++u)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        v[u][m] = s0 + u < n_splits
                      ? __ldcg(tile_part + ((s0 + u) * kM + m) * kSThreads)
                      : make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kSPartLoads; ++u)
      if (s0 + u < n_splits)
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          tot[m].x += v[u][m].x;
          tot[m].y += v[u][m].y;
        }
  }
  finish(tot);
  if (tid == 0) counters[t] = 0;  // ready for the next launch
}

template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads, 2)
dequant_gemv_kernel(const __grid_constant__ CUtensorMap tq,
                    const T* __restrict__ x, int ldx, int vec,
                    const float* __restrict__ scale,
                    float* __restrict__ part, unsigned* __restrict__ counters,
                    void* __restrict__ out, int out_type, int M, int K, int N,
                    int rows) {
  using S = Stage<kTile>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tile = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int k0 = split * rows;
  const int n = min(rows, K - k0);  // > 0: the host makes ceil(K / rows)
  const int n_steps = (n + kStep - 1) / kStep;
  const int n_stages = (n_steps + S::kSteps - 1) / S::kSteps;
  uint16_t* sx = reinterpret_cast<uint16_t*>(ring + kRingBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      ring + kRingBytes + n_steps * 32 * 8);
  int* s_last = reinterpret_cast<int*>(bars + 2 * kStages);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + kStages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  // Consumer warp w reads the 64 columns of group grp of the tile, and
  // k-step kstep of every stage.
  const int grp = warp % S::kGroups, kstep = warp / S::kGroups;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = kGroup * grp + 8 * col_group(g);

  if (warp == kWarps) {
    // The producer: one stage at a time, each into a slot all 8 consumer
    // warps have freed.  The whole warp walks the ring (lane 0 issues), so
    // it reaches the block's barriers below converged.
    const uint32_t ring_s = smem_addr(ring);
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kStages;
      if (st >= kStages)
        mbar_wait(empty0 + 8 * slot, (st / kStages - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(full0 + 8 * slot, kStageBytes);
#pragma unroll
        for (int b = 0; b < S::kBoxes; ++b)
          tma_load_3d(ring_s + slot * kStageBytes + b * S::kRows * S::kBox,
                      &tq, full0 + 8 * slot, tile * kTile + b * S::kBox,
                      k0 + st * S::kRows, 0);
      }
      __syncwarp();
    }
  } else {
    stage_x<T>(x, ldx, vec, M, k0, n, n_steps, sx, tid);
    __syncwarp();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
    const uint2* sxf = reinterpret_cast<const uint2*>(sx);
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kStages;
      mbar_wait(full0 + 8 * slot, (st / kStages) & 1);
      const int ks = st * S::kSteps + kstep;
      const bool live = ks < n_steps;  // warp-uniform
      uint2 w[4], b = make_uint2(0u, 0u);
      if (live) {
        const uint8_t* stage = ring + slot * kStageBytes;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const uint2*>(
              stage + stage_offset<kTile>(kStep * kstep + 4 * j + t, col0));
        b = sxf[ks * 32 + lane];
      }
      uint32_t a[4][4];
      if (live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // tile i: A rows g and g + 8 are columns col0 + 2i and + 1
          const uint32_t r0 = i < 2 ? w[0].x : w[0].y;
          const uint32_t r1 = i < 2 ? w[1].x : w[1].y;
          const uint32_t r2 = i < 2 ? w[2].x : w[2].y;
          const uint32_t r3 = i < 2 ? w[3].x : w[3].y;
          const int p = (2 * i) & 3;
          a[i][0] = cvt_pair<T>(r0, r1, p);
          a[i][1] = cvt_pair<T>(r0, r1, p + 1);
          a[i][2] = cvt_pair<T>(r2, r3, p);
          a[i][3] = cvt_pair<T>(r2, r3, p + 1);
        }
      }
      // The slot is released only once the words read from it are in
      // registers (converted), and after a proxy fence: the next box is
      // written by TMA (the async proxy) over what these loads read.
      // Arriving right after issuing the loads let TMA overwrite a slot
      // still being read when two blocks shared an SM.
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      if (live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mma16816<T>(acc[i], a[i], b.x, b.y);
      }
    }
  }

  // The warps' sums meet in shared memory (the ring, whose every box has
  // been waited for), row by row of x, then in k-step order.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [kstep][m][kRedStride]
  if (warp < kWarps) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // acc: rows (columns) col0 + 2i, + 1; cols (rows of x) 2t, 2t + 1
      float* r = red + (kstep * kMaxM + 2 * t) * S::kRedStride + col0 + 2 * i;
      if (2 * t < M)
        *reinterpret_cast<float2*>(r) = make_float2(acc[i][0], acc[i][2]);
      if (2 * t + 1 < M)
        *reinterpret_cast<float2*>(r + S::kRedStride) =
            make_float2(acc[i][1], acc[i][3]);
    }
  }
  __syncthreads();
  // Thread tid < 256 owns row m = tid / 32 and columns c2, c2 + 1 of each
  // 64-column group.
  const int m = tid / 32;
  const bool row_mine = tid < kWarps * 32 && m < M;
  float2 sc[S::kGroups];
#pragma unroll
  for (int u = 0; u < S::kGroups; ++u) {
    const int n_col = tile * kTile + kGroup * u + 2 * (tid % 32);
    sc[u] = make_float2(0.f, 0.f);
    if (row_mine && n_col < N) {
      const int c2 = n_col - tile * kTile;
      sc[u] = *reinterpret_cast<const float2*>(scale + n_col);
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < S::kSteps; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(
            red + (k * kMaxM + m) * S::kRedStride + c2);
        s.x += v.x;
        s.y += v.y;
      }
      if (n_splits == 1)
        store2(out, out_type, (long)m * N + n_col, s.x * sc[u].x,
               s.y * sc[u].y);
      else
        *reinterpret_cast<float2*>(part + ((long)split * M + m) * N + n_col) =
            s;
    }
  }
  if (n_splits == 1) return;

  // The last split of this column tile to finish adds them all, in order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned done = atomicAdd(&counters[tile], 1u);
    *s_last = done == static_cast<unsigned>(n_splits - 1);
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
#pragma unroll
  for (int u = 0; u < S::kGroups; ++u) {
    const int n_col = tile * kTile + kGroup * u + 2 * (tid % 32);
    if (row_mine && n_col < N) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int sp = 0; sp < n_splits; ++sp) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(
            part + ((long)sp * M + m) * N + n_col));
        s0 += v.x;
        s1 += v.y;
      }
      store2(out, out_type, (long)m * N + n_col, s0 * sc[u].x, s1 * sc[u].y);
    }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

// The tensor map of a weight [K][N] int8 with a [box_rows][box] box and the
// box-wide swizzle, encoded once per weight and box shape and kept: a decode
// step reuses the same ~225 weights every step.  Locked: ctypes releases
// the GIL, so two host threads may launch at once.
bool weight_map(CUtensorMap* map, const void* q, int K, int N, int box,
                int box_rows) {
  struct Key {
    const void* q;
    int K, N, box, box_rows;
    bool operator==(const Key& o) const {
      return q == o.q && K == o.K && N == o.N && box == o.box &&
             box_rows == o.box_rows;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.q) ^ (size_t(k.K) << 20) ^
             (size_t(k.N) << 4) ^ (size_t(k.box_rows) << 40) ^ k.box;
    }
  };
  static std::unordered_map<Key, CUtensorMap, Hash> maps;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  const Key key{q, K, N, box, box_rows};
  auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  if (!make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K, 1, box,
                   box_rows,
                   box == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (maps.size() >= 4096) maps.clear();  // a map is a pure function of key
  maps.emplace(key, *map);
  return true;
}

template <typename T, int kTile>
cudaError_t launch(const void* x, int ldx, const void* q, const void* scale,
                   void* part, void* counters, void* out, int out_type, int M,
                   int K, int N, int rows, cudaStream_t stream) {
  using S = Stage<kTile>;
  CUtensorMap map;
  if (!weight_map(&map, q, K, N, S::kBox, S::kRows))
    return cudaErrorNotSupported;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        dequant_gemv_kernel<T, kTile>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxRows));
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (M == 1 || ldx % 8 == 0);
  const dim3 grid((N + kTile - 1) / kTile, (K + rows - 1) / rows);
  dequant_gemv_kernel<T, kTile><<<grid, kThreads, smem_bytes(rows), stream>>>(
      map, static_cast<const T*>(x), ldx, vec,
      static_cast<const float*>(scale), static_cast<float*>(part),
      static_cast<unsigned*>(counters), out, out_type, M, K, N, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int tile, const void* x, int ldx, const void* q,
                     const void* scale, void* part, void* counters, void* out,
                     int out_type, int M, int K, int N, int rows,
                     cudaStream_t st) {
  switch (tile) {
    case 64:
      return launch<T, 64>(x, ldx, q, scale, part, counters, out, out_type,
                           M, K, N, rows, st);
    case 128:
      return launch<T, 128>(x, ldx, q, scale, part, counters, out, out_type,
                            M, K, N, rows, st);
    case 256:
      return launch<T, 256>(x, ldx, q, scale, part, counters, out, out_type,
                            M, K, N, rows, st);
  }
  return cudaErrorInvalidValue;
}

// The streaming kernel over `tiles` column tiles of the group: with kPro
// a prologue, with kRopeD > 0 the RoPE + KV-cache epilogue.
template <typename T, int kM, int kPro, int kRopeD>
cudaError_t launch_stream_mode(const StreamGroup& g, int tiles, const void* x,
                               int ldx, int K, int rows, void* part,
                               void* counters, int out_type,
                               const NormArgs& na, const RopeArgs& ra,
                               cudaStream_t st) {
  const dim3 grid(tiles, (K + rows - 1) / rows);
  dequant_gemv_stream_kernel<T, kM, kPro, kRopeD><<<grid, kSThreads, 0, st>>>(
      g, static_cast<const uint16_t*>(x), ldx, K, rows,
      static_cast<float*>(part), static_cast<unsigned*>(counters), out_type,
      na, ra);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream(const StreamGroup& g, int tiles, const void* x,
                          int ldx, int M, int K, int rows, void* part,
                          void* counters, int out_type, cudaStream_t st) {
  const NormArgs na{};
  const RopeArgs ra{};
  if (M == 1)
    return launch_stream_mode<T, 1, kProNone, 0>(g, tiles, x, ldx, K, rows, part,
                                              counters, out_type, na, ra, st);
  return launch_stream_mode<T, 2, kProNone, 0>(g, tiles, x, ldx, K, rows, part,
                                            counters, out_type, na, ra, st);
}

template <typename T, int kM>
cudaError_t launch_norm_rows(const StreamGroup& g, int tiles, const void* x,
                             int K, int rows, void* part, void* counters,
                             int out_type, const NormArgs& na,
                             const RopeArgs& ra, int head_dim,
                             cudaStream_t st) {
  switch (head_dim) {
    case 0:
      return launch_stream_mode<T, kM, kProNorm, 0>(g, tiles, x, K, K, rows, part,
                                                counters, out_type, na, ra,
                                                st);
    case 64:
      return launch_stream_mode<T, kM, kProNorm, 64>(g, tiles, x, K, K, rows,
                                                 part, counters, out_type, na,
                                                 ra, st);
    case 128:
      return launch_stream_mode<T, kM, kProNorm, 128>(g, tiles, x, K, K, rows,
                                                  part, counters, out_type,
                                                  na, ra, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_norm(const StreamGroup& g, int tiles, const void* x, int M,
                        int K, int rows, void* part, void* counters,
                        int out_type, const NormArgs& na, const RopeArgs& ra,
                        int head_dim, cudaStream_t st) {
  if (M == 1)
    return launch_norm_rows<T, 1>(g, tiles, x, K, rows, part, counters,
                                  out_type, na, ra, head_dim, st);
  return launch_norm_rows<T, 2>(g, tiles, x, K, rows, part, counters,
                                out_type, na, ra, head_dim, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y_i = (x @ q_i) * scale_i for M in 1..8 rows of x and n_members (1 to 3)
// weights that share it, over column tiles of `tile` columns: 512 is the
// streaming kernel (M <= 2, one to three members, one launch; `rows`, the
// K range of one block, a multiple of 8: a run of rows a warp), 64, 128 or
// 256 the tensor-core kernel (one member; `rows` a multiple of 16 up to
// 2048).  K splits into ceil(K / rows) blocks a tile, and with more than
// one, `part` and `counters` are the split scratch: the streaming kernel's
// partials are [tiles][splits][M][512] over every member's tiles, the
// tensor-core kernel's [splits][M][N].
extern "C" int mc_w8a16_gemv(const void* x, int n_members,
                             const void* const* q, const void* const* scale,
                             void* const* out, const int* N, void* part,
                             void* counters, int M, int K, int ldx, int rows,
                             int tile, int x_bf16, int out_type,
                             void* stream) {
  if (M < 1 || M > kMaxM || K <= 0 || rows <= 0 || n_members < 1 ||
      n_members > kMaxMembers || (M > 1 && ldx < K) || out_type < kOutF32 ||
      out_type > kOutF16)
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_members; ++i)
    if (N[i] <= 0 || N[i] % 16 != 0 ||
        reinterpret_cast<uintptr_t>(q[i]) % 16 != 0)
      return cudaErrorInvalidValue;
  const bool streaming = tile == kSTile;
  if (streaming ? M > kSMaxM || rows % kSWarps != 0
                : n_members != 1 || (tile != 64 && tile != 128 &&
                                     tile != 256) ||
                      rows % kStep != 0 || rows > kMaxRows)
    return cudaErrorInvalidValue;
  const int n_splits = (K + rows - 1) / rows;
  if (n_splits > 65535 || (n_splits > 1 && (!part || !counters)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (streaming) {
    StreamGroup g{};
    int tiles = 0;
    for (int i = 0; i < n_members; ++i) {
      g.m[i] = StreamMember{static_cast<const int8_t*>(q[i]),
                            static_cast<const float*>(scale[i]), out[i], N[i],
                            tiles, kStore};
      tiles += (N[i] + kSTile - 1) / kSTile;
    }
    g.n = n_members;
    if (x_bf16)
      return launch_stream<__nv_bfloat16>(g, tiles, x, ldx, M, K, rows, part,
                                          counters, out_type, st);
    return launch_stream<__half>(g, tiles, x, ldx, M, K, rows, part, counters,
                                 out_type, st);
  }
  if (x_bf16)
    return dispatch<__nv_bfloat16>(tile, x, ldx, q[0], scale[0], part,
                                   counters, out[0], out_type, M, K, N[0],
                                   rows, st);
  return dispatch<__half>(tile, x, ldx, q[0], scale[0], part, counters, out[0],
                          out_type, M, K, N[0], rows, st);
}

// The streaming kernel (1-2 rows, one to three members that share x) with
// kernel K8 folded into its prologue and, where head_dim is 64 or 128,
// kernel K9 into its epilogue.  x [M, K] (and y, or null) bf16 (x_bf16) or
// fp16 with contiguous rows, the norm's weight [K]: the products read
// h = rms_norm(s) * w of s = x + y (or x), eps as given; `sum` (where y is
// given) receives s and `h` (or null) h, both [M, K].  `rows`, `part` and
// `counters` as mc_w8a16_gemv's streaming kernel takes them.  With
// head_dim, the members are q, k and v in that order, the outputs of x's
// type (out_type), each N a multiple of head_dim and k's and v's Hkv heads:
// out[0] receives q rotated (cos, sin [M, head_dim] fp32), out[1] and
// out[2] are not written, and k (rotated) and v go to row m's slot [layer,
// m, pos[m]] of the caches [NL, M, S, Hkv, head_dim]: int8 with fp32
// scales [NL, M, S, Hkv, 1] where scale_k and scale_v are given, else of
// x's type.  Returns cudaErrorInvalidValue, launching nothing, for M
// outside 1..2, K % 8, K > 8,192, a pointer the kernel reads 16 bytes at a
// time that is not 16-byte aligned, or a RoPE group it does not take.
extern "C" int mc_w8a16_gemv_norm(
    const void* x, const void* y, const void* norm_w, void* sum, void* h,
    float eps, int n_members, const void* const* q, const void* const* scale,
    void* const* out, const int* N, void* part, void* counters, int M, int K,
    int rows, int x_bf16, int out_type, int head_dim, const void* cos,
    const void* sin, void* cache_k, void* cache_v, void* scale_k,
    void* scale_v, const void* pos, int pos64, int S, int Hkv, int layer,
    void* stream) {
  if (M < 1 || M > kSMaxM || K < 8 || K % 8 || K > kSNormMaxK || rows <= 0 ||
      rows % kSWarps != 0 || n_members < 1 || n_members > kMaxMembers ||
      out_type < kOutF32 || out_type > kOutF16 || !aligned16(x) ||
      !aligned16(norm_w) || (y != nullptr && (!aligned16(y) || !aligned16(sum)))
      || (h != nullptr && !aligned16(h)))
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_members; ++i)
    if (N[i] <= 0 || N[i] % 16 != 0 || !aligned16(q[i]))
      return cudaErrorInvalidValue;
  const int n_splits = (K + rows - 1) / rows;
  if (n_splits > 65535 || (n_splits > 1 && (!part || !counters)))
    return cudaErrorInvalidValue;
  RopeArgs ra{};
  if (head_dim != 0) {
    const int half_type = x_bf16 ? kOutBF16 : kOutF16;
    if ((head_dim != 64 && head_dim != 128) || n_members != 3 ||
        out_type != half_type || Hkv < 1 || N[1] != Hkv * head_dim ||
        N[2] != Hkv * head_dim || N[0] % head_dim != 0 || S < 1 ||
        layer < 0 || !cos || !sin || !cache_k || !cache_v || !pos || !out[0]
        || (scale_k == nullptr) != (scale_v == nullptr))
      return cudaErrorInvalidValue;
    ra = RopeArgs{static_cast<const float*>(cos),
                  static_cast<const float*>(sin), cache_k, cache_v,
                  static_cast<float*>(scale_k), static_cast<float*>(scale_v),
                  pos, pos64, S, Hkv, layer};
  }
  StreamGroup g{};
  int tiles = 0;
  for (int i = 0; i < n_members; ++i) {
    const int role = head_dim == 0 ? kStore : kRopeQ + i;
    g.m[i] = StreamMember{static_cast<const int8_t*>(q[i]),
                          static_cast<const float*>(scale[i]), out[i], N[i],
                          tiles, role};
    tiles += (N[i] + kSTile - 1) / kSTile;
  }
  g.n = n_members;
  const NormArgs na{static_cast<const uint16_t*>(y),
                    static_cast<const uint16_t*>(norm_w),
                    static_cast<uint16_t*>(sum), static_cast<uint16_t*>(h),
                    eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_norm<__nv_bfloat16>(g, tiles, x, M, K, rows, part, counters,
                                      out_type, na, ra, head_dim, st);
  return launch_norm<__half>(g, tiles, x, M, K, rows, part, counters,
                             out_type, na, ra, head_dim, st);
}

// The streaming kernel (1-2 rows, one weight) with kernel K10 folded into
// its prologue: y = (h @ q) * scale of h = T(T(silu(gate)) * up), the down
// product of the decode layer's MLP.  gate and up [M, K] bf16 (x_bf16) or
// fp16 with contiguous rows; `h` (or null) receives h [M, K] (an adapter
// branch's input); `rows`, `part` and `counters` as mc_w8a16_gemv's
// streaming kernel takes them (the grid over the weight's 512-column
// tiles).  Bit-equal to K10, then mc_w8a16_gemv's streaming kernel with
// the same rows.  Returns cudaErrorInvalidValue, launching nothing, for M
// outside 1..2, rows not a positive multiple of 8, N % 16, a misaligned
// weight or pointer read 16 bytes at a time, or an output type it does
// not write.
extern "C" int mc_w8a16_gemv_silu(const void* gate, const void* up, void* h,
                                  const void* q, const void* scale,
                                  void* out, int N, void* part,
                                  void* counters, int M, int K, int rows,
                                  int x_bf16, int out_type, void* stream) {
  if (M < 1 || M > kSMaxM || K <= 0 || rows <= 0 || rows % kSWarps != 0 ||
      N <= 0 || N % 16 != 0 || !aligned16(q) || !aligned16(scale) ||
      !aligned16(gate) || !aligned16(up) || out_type < kOutF32 ||
      out_type > kOutF16)
    return cudaErrorInvalidValue;
  const int n_splits = (K + rows - 1) / rows;
  if (n_splits > 65535 || (n_splits > 1 && (!part || !counters)))
    return cudaErrorInvalidValue;
  StreamGroup g{};
  g.m[0] = StreamMember{static_cast<const int8_t*>(q),
                        static_cast<const float*>(scale), out, N, 0, kStore};
  g.n = 1;
  const int tiles = (N + kSTile - 1) / kSTile;
  const NormArgs na{static_cast<const uint16_t*>(up), nullptr, nullptr,
                    static_cast<uint16_t*>(h), 0.f};
  const RopeArgs ra{};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return M == 1 ? launch_stream_mode<__nv_bfloat16, 1, kProSilu, 0>(
                        g, tiles, gate, K, K, rows, part, counters, out_type,
                        na, ra, st)
                  : launch_stream_mode<__nv_bfloat16, 2, kProSilu, 0>(
                        g, tiles, gate, K, K, rows, part, counters, out_type,
                        na, ra, st);
  return M == 1 ? launch_stream_mode<__half, 1, kProSilu, 0>(
                      g, tiles, gate, K, K, rows, part, counters, out_type,
                      na, ra, st)
                : launch_stream_mode<__half, 2, kProSilu, 0>(
                      g, tiles, gate, K, K, rows, part, counters, out_type,
                      na, ra, st);
}
