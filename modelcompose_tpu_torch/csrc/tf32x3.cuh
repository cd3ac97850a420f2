// fp32 products of the attention kernels' fp32 instantiations (K1, K3, K4):
// 3xTF32 on the tensor cores through mma.sync, with every fragment loaded
// from shared memory by hand, and the cp.async tile loads that feed them.
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
// Why mma.sync and not wgmma: wgmma's tf32 form reads both shared-memory
// operands K-major only (the transposed layout exists for 16-bit types),
// while the second products (P.V, dS.K, P^T.dO, dS^T.Q) read their
// streamed operand along its rows.  mma.sync m16n8k8 takes fragments from
// registers, loaded here from row-major tiles in either direction.
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

}  // namespace tf32x3
