// fp32 products of the attention kernels' fp32 instantiations: 3xTF32 on
// the tensor cores.  K3's fa_bwd_dq_f32_kernel runs them through mma.sync,
// with every fragment loaded from shared memory by hand and fed by the
// cp.async tile loads below; K1's and K4's fp32 kernels run them on wgmma
// (the last section).
//
// Why 3xTF32: the JAX kernels feed fp32 operands to the dot with fp32
// accumulation, which the TPU's matrix unit runs in multiple passes at
// about fp32 accuracy.  TF32 alone keeps 10 mantissa bits and misses that
// by two orders of magnitude.  Each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in fp32), and a
// product accumulates lo_a hi_b + hi_a lo_b + hi_a hi_b in fp32: what is
// dropped (lo_a lo_b, and lo's own rounding) is below 2^-21 of |a||b|.
//
// The tensor cores add each mma's products into its accumulator with
// truncation, not round-to-nearest, so a long chain of mma into one
// accumulator drifts toward zero by about an ulp of the sum a step (on the
// H100, K1 at a 3,072-key row came out 3.2e-5 of max |O| from the plain
// fp32 product with one chain over every key tile).  So the small terms go
// into an accumulator of their own (its truncation is 2^-11 of the big
// one's), the big chain runs over one tile's depth only, and a caller adds
// each tile's product into its running sum with an fp32 add.
//
// mma.sync: wgmma's tf32 form reads both shared-memory operands K-major
// only (the transposed layout exists for 16-bit types), while the second
// products (P.V, dS.K, P^T.dO, dS^T.Q) read their streamed operand along
// its rows.  mma.sync m16n8k8 takes fragments from registers, loaded here
// from row-major tiles in either direction.  (The wgmma kernels of the
// last section take such an operand as a transposed tile instead.)
//
// Fragment layout of mma.m16n8k8 .tf32 (lane = 4 g + t): A a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g),
// b1 (k t + 4, n g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).  A C tile of a first product becomes the A operand
// of a second one with no shuffle by a permutation of the 8-deep k step:
// logical k = t is the C column 2t and k = t + 4 the column 2t + 1, so
// a = (c0, c2, c1, c3) and the B operand reads rows 2t and 2t + 1 of its
// 8-row slice.
//
// Shared-memory tiles are row-major with a row stride of D + 4 floats:
// the K-major fragment reads (row g, column t) then hit banks 4g + t and
// the row-pair reads (row 2t, column g) banks 8t + g, 32 distinct banks
// either way.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// Row stride, in floats, of a D-column fp32 tile in shared memory.
template <int D>
__host__ __device__ constexpr int stride() {
  return D + 4;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, both tf32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// big + small += a b at about fp32 accuracy, from operands already split:
// the hi-hi product into `big`, the two cross terms into `small`.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(small, al, bh);
  mma(small, ah, bl);
  mma(big, ah, bh);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// The A fragment of rows r0..r0+15, columns k0..k0+7 of a row-major tile
// (row stride ld floats), split.
__device__ __forceinline__ void load_a(const float* tile, int ld, int r0,
                                       int k0, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = tile + (r0 + g) * ld + k0 + t;
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  split(x, hi, lo);
}

// The B fragment of a product with a row-major tile read K-major: B[k][n]
// = tile[n0 + n][k0 + k] (S = Q K^T with K's rows as the n axis), split.
__device__ __forceinline__ void load_b_kmajor(const float* tile, int ld,
                                              int n0, int k0, int g, int t,
                                              uint32_t (&hi)[2],
                                              uint32_t (&lo)[2]) {
  const float* p = tile + (n0 + g) * ld + k0 + t;
  const float x[2] = {p[0], p[4]};
  split(x, hi, lo);
}

// The B fragment of a product whose A came from a C tile (the permuted k
// step): B[k][n] = tile[k0 + 2t (+1)][n0 + n] (P.V with V's rows as the k
// axis), split.
__device__ __forceinline__ void load_b_rows(const float* tile, int ld, int k0,
                                            int n0, int g, int t,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const float* p = tile + (k0 + 2 * t) * ld + n0 + g;
  const float x[2] = {p[0], p[ld]};
  split(x, hi, lo);
}

// The A fragment of a second product from the C tile c of a first one,
// split (see the permutation above).
__device__ __forceinline__ void a_from_c(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split(x, hi, lo);
}

// s = A B^T of one warp: 16 rows of the row-major tile `a` (from row r0)
// against the first 8 NT rows of the row-major tile `b`, both D wide, as
// the 16 x 8 NT C tile s (S = Q K^T, dP = dO V^T and their transposes).
template <int D, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* a,
                                       int r0, const float* b, int g, int t) {
  constexpr int ld = stride<D>();
  float small[NT][4];
  zero(s);
  zero(small);
#pragma unroll 4
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    load_a(a, ld, r0, kk * 8, g, t, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      load_b_kmajor(b, ld, nt * 8, kk * 8, g, t, bh, bl);
      mma3(s[nt], small[nt], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += small[nt][e];
}

// acc += c . tile of one warp: the 16 x 8 KT C tile c (P, dS or their
// transposes) times the first 8 KT rows of the row-major tile `tile`, D
// wide (P.V, dS.K, P^T.dO, dS^T.Q).  The product is formed CH 8-column
// blocks at a time in accumulators of its own and added to acc in fp32.
template <int D, int KT, int CH>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&c)[KT][4],
                                           const float* tile, int g, int t) {
  constexpr int ld = stride<D>();
  static_assert((D / 8) % CH == 0, "whole column chunks");
#pragma unroll
  for (int c0 = 0; c0 < D / 8; c0 += CH) {
    float big[CH][4], small[CH][4];
    zero(big);
    zero(small);
#pragma unroll
    for (int kj = 0; kj < KT; ++kj) {
      uint32_t ah[4], al[4];
      a_from_c(c[kj], ah, al);
#pragma unroll
      for (int dt = 0; dt < CH; ++dt) {
        uint32_t bh[2], bl[2];
        load_b_rows(tile, ld, kj * 8, (c0 + dt) * 8, g, t, bh, bl);
        mma3(big[dt], small[dt], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int dt = 0; dt < CH; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + dt][e] += big[dt][e] + small[dt][e];
  }
}

// 16 bytes from global to shared memory without the register file; with
// `valid` false the 16 bytes are zero-filled and nothing is read (src must
// still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0..r0+R-1 of one head of a [.., L, heads, D] fp32 tensor (row r of
// batch row b at base + ((b L + r) heads + head) D) into a row-major tile
// at `dst` (shared address, row stride stride<D>()), rows past L as zeros;
// the block's `threads` threads share the copies.
template <int R, int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* base,
                                          int b, int L, int heads, int head,
                                          int r0, int tid, int threads) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  for (int i = tid; i < R * kChunks; i += threads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = r0 + r < L;
    const float* src =
        valid ? base + (((long)b * L + r0 + r) * heads + head) * D + c * 4
              : base;
    cp_async16(dst + (r * stride<D>() + c * 4) * 4, src, valid);
  }
}

// ------------------------------------------------------------------ wgmma
// The redesigned fp32 kernels (K1's fa_fwd_f32_kernel, K4's
// fa_bwd_dkv_f32_kernel) run every product on wgmma's tf32 form from
// TMA-fed shared memory instead, with each operand split once: once per
// block for the block's own rows, once per tile for a streamed tile.
//
// wgmma m64nNk8 .tf32 reads both shared-memory operands K-major only (the
// 8-deep k axis contiguous; there is no transposed form for 4-byte types),
// so a product whose streamed operand is read along its rows (P.V, P^T.dO,
// dS^T.Q) takes that tile transposed: row n of the transposed tile holds
// column n of the streamed one, its k axis along the 128-byte row.  Its A
// operand is P, P^T or dS^T from registers: wgmma's tf32 A fragment (warp
// w, lane 4g + t: a0 (16w + g, t), a1 (16w + g + 8, t), a2 (16w + g, t + 4),
// a3 (16w + g + 8, t + 4)) is the first product's accumulator (c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1) of each 8 columns) as
// (c0, c2, c1, c3) when the k step is permuted: logical k = t is column 2t
// and k = t + 4 column 2t + 1.  So each 8-row block of the streamed tile
// goes into the transposed tile in the order 0, 2, 4, 6, 1, 3, 5, 7
// (`kpos`), and the accumulator serves as the A fragment with no shuffle.
//
// hi and lo are written as tf32 values (low 13 bits zero), so the product
// does not depend on how wgmma reads the low bits of an fp32 word.

// Position of row r of an 8-row block in the transposed tile's k order.
__host__ __device__ constexpr int kpos(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// Byte offset of fp32 element (row, col) in a TMA box of 32 columns (128
// bytes a row) written with the 128-byte swizzle from a 1024-aligned base.
__device__ __forceinline__ uint32_t sw128_f32(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// x - hi (exact, finite and small where x is finite) rounded to tf32 as
// cvt.rna rounds (to nearest, ties away from zero) in two integer ops.
__device__ __forceinline__ float lo_of(float x, float hi) {
  return __uint_as_float((__float_as_uint(x - hi) + 0x1000u) & 0xFFFFE000u);
}

// hi by cvt.rna (NaN and Inf kept), lo beside it: the converters' split.
__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  const float4 h = make_float4(__uint_as_float(to_tf32(x.x)),
                               __uint_as_float(to_tf32(x.y)),
                               __uint_as_float(to_tf32(x.z)),
                               __uint_as_float(to_tf32(x.w)));
  lo = make_float4(lo_of(x.x, h.x), lo_of(x.y, h.y), lo_of(x.z, h.z),
                   lo_of(x.w, h.w));
  return h;
}

// A TMA-landed tile of R rows by D fp32 columns ([D/32 boxes][R rows]
// [128 B], swizzled) split in place: hi over x, lo into a tile of the same
// layout.  The `threads` threads from `tid` share the 16-byte chunks, four
// loads in flight a thread.
template <int R, int D>
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* lo,
                                           int tid, int threads) {
  constexpr int kChunks = R * D / 4;
  float4* x4 = reinterpret_cast<float4*>(tile);
  for (int i0 = tid; i0 < kChunks; i0 += 4 * threads) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * threads;
      if (i < kChunks) x[u] = x4[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * threads;
      if (i < kChunks) {
        float4 l;
        x4[i] = split4(x[u], l);
        reinterpret_cast<float4*>(lo)[i] = l;
      }
    }
  }
}

// A 32-row tile of D fp32 columns transposed and split: element (r, d) to
// row d, k position kpos(r) of the hi and lo tiles ([D rows][128 B],
// swizzled), the K-major B operand of a product that sums over the 32
// rows.  Each thread keeps one row (tid % 32, so `threads` is a multiple
// of 32) and walks its 4-column chunks, four loads in flight: a warp's
// reads hit eight distinct 16-byte columns a quarter warp and its writes
// 32 banks.
template <int D>
__device__ __forceinline__ void transpose_split_tile(const uint8_t* tile,
                                                     uint8_t* hi, uint8_t* lo,
                                                     int tid, int threads) {
  constexpr int kDc = D / 4;  // 4-column chunks
  const int r = tid % 32, w = tid / 32, nw = threads / 32;
  const int p = kpos(r);
  const uint8_t* src = tile + r * 128;
  for (int dc0 = w; dc0 < kDc; dc0 += 4 * nw) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int dc = dc0 + u * nw;
      if (dc < kDc)
        x[u] = *reinterpret_cast<const float4*>(
            src + (dc / 8) * 32 * 128 + (((dc ^ r) & 7) << 4));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int dc = dc0 + u * nw;
      if (dc < kDc) {
        float4 l;
        const float4 h = split4(x[u], l);
        const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t off = sw128_f32(dc * 4 + e, p);
          *reinterpret_cast<float*>(hi + off) = hv[e];
          *reinterpret_cast<float*>(lo + off) = lv[e];
        }
      }
    }
  }
}

// A warpgroup's 64 own rows ([D/32 boxes][64 rows][128 B], swizzled) split
// once: hi in place (the shared-memory A operand), lo as the register A
// fragments of each 8-deep step (a0 (row, t), a1 (row + 8, t), a2 (row,
// t + 4), a3 (row + 8, t + 4), row = 16 warp + g).  Each element of the 64
// rows belongs to one thread.
template <int D>
__device__ __forceinline__ void split_rows(uint8_t* tile,
                                           uint32_t (&lo)[D / 8][4],
                                           int warp, int g, int t) {
  const int row = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint8_t* box = tile + (kk / 4) * 64 * 128;
    const int col = (kk % 4) * 8 + t;
    float* p[4] = {reinterpret_cast<float*>(box + sw128_f32(row, col)),
                   reinterpret_cast<float*>(box + sw128_f32(row + 8, col)),
                   reinterpret_cast<float*>(box + sw128_f32(row, col + 4)),
                   reinterpret_cast<float*>(box + sw128_f32(row + 8, col + 4))};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t hi;
      split(*p[i], hi, lo[kk][i]);
      *p[i] = __uint_as_float(hi);
    }
  }
}

#define TF32X3_ACC16 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define TF32X3_REGS16 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15}"

// D[64 x 32] (+)= A[64 x 8] B[8 x 32] in tf32 (fp32 accumulators in the
// m64n32 layout), both operands from shared memory, K-major, 128-byte
// swizzle; `accumulate` 0 starts the chain from zero (scale-d).
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TF32X3_REGS16
      ", %16, %17, p, 1, 1;\n}\n"
      : TF32X3_ACC16 : "l"(da), "l"(db), "r"(accumulate));
}

// The same with A (64 rows by 8) from registers: each warp's m16k8 tf32
// fragment (see above).
__device__ __forceinline__ void wgmma_rs32(float* d, const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TF32X3_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : TF32X3_ACC16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The A fragment of 8 columns of an m64n32 accumulator (c = its 4 floats
// of those columns, in the layout above), split: (c0, c2, c1, c3) under
// the permuted k step.
__device__ __forceinline__ void a_from_acc(const float* c, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

}  // namespace tf32x3
