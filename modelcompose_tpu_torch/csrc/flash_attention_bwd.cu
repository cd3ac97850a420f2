// Flash-attention backward (kernels K3 and K4) for Hopper, sm_90a: TMA loads
// and stores, wgmma, one producer warp and two consumer warpgroups per block.
//
// K3 replaces the Pallas TPU kernel modelcompose_tpu/ops/flash_attention.py
// `_bwd_dq_kernel`, K4 replaces `_bwd_dkv_kernel` (both driven by
// `_flash_attention_backward`).  With P = exp(S * scale - LSE) under the
// mask (same segment, kv segment != 0, causal q_offset + i >= j) and
// Di = rowsum(O * dO) computed by the wrapper:
//     dP = dO V^T,  dS = P * (dP - Di) * scale,
//     K3: dQ = dS K            K4: dV = P^T dO,  dK = dS^T Q
// The mask is a select, not an underflow: a padding row's LSE is about
// -1e30, so exp(S - LSE) there is not 0 and must be masked explicitly.
//
// What bounds them on the H100: tensor-core FLOPs.  At B = 2, L = 2,048,
// 32 heads, D = 128, causal, K3 does 6 D and K4 8 D flops per valid
// (q, kv) pair (75 and 100 GFLOP) over ~70 MB of inputs, far above the
// ~295 flop/byte ridge, so the road to the card's rate is wgmma fed by TMA.
// Both kernels are built from the forward's (K1) pieces:
//   - 384 threads: warp 0 is the producer (setmaxnreg 24) and issues every
//     load; warpgroups 1 and 2 are consumers (setmaxnreg 240) and own 64
//     rows each of the block's 128;
//   - TMA tensor maps over the public layouts as 3-D [B][L][heads * D],
//     64-column boxes, 128-byte swizzle: a box never crosses into the next
//     batch row, rows past L arrive as zeros, and the stores of the
//     results (through the block's own operand tiles in shared memory)
//     drop rows past L;
//   - the block's own rows are loaded once; the other side streams through
//     a ring of stages with full/empty mbarriers, each stage carrying its
//     rows' segment ids with their min and max (and for K4 the LSE, scaled
//     by log2(e) for exp2f, and Di);
//   - products where both operands are tiles are wgmma from shared memory,
//     K-major; the second products take the just-computed P^T or dS (dS^T)
//     from registers in T (the JAX kernels' _gemm2_cast) as the A
//     operand and the streamed tile as the MN-major B operand, as K1 does
//     with P.V;
//   - per tile a warpgroup issues its two score products together, turns
//     the first into P while the tensor cores do the second, and leaves
//     the tile's last accumulating product (dQ in K3, dK in K4) in flight
//     across the next tile's score products;
//   - the producer fetches the next tile's segment ids (and LSE, Di) into
//     registers while it waits for a free stage;
//   - a warp whose 16 rows all share the tile's one nonzero segment, with
//     the tile wholly on the past side of its diagonal, skips the
//     per-element mask (the `_mask_all` entries force it, for the test that
//     holds the two bit-equal); tiles a warpgroup cannot see (causal
//     future, all padding) are released unread, a tile of padding rows is
//     not even loaded, and a block whose own rows are all padding writes
//     zeros and exits (a ragged batch's padded tail costs next to nothing);
//   - the heaviest blocks launch first (the causal tail is light blocks).
// K3: one block per (128-row q tile, q head, batch row); Q, dO, LSE and Di
// stay, K, V and the kv segment ids stream in kBlockN-row tiles; S = Q K^T
// and dP = dO V^T, then dQ += dS K.
// K4: one block per (128-row kv tile, KV head, batch row); K and V stay, Q
// and dO stream in 64-row tiles over every q head of the GQA group, from
// the first q tile that can see the block's rows; S^T = K Q^T and
// dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.  The group sum stays
// in the fp32 accumulators: dK/dV are written once as [B, S, Hkv, D], with
// no atomics and no [B, H, S, D] buffer, and the result is deterministic.
//
// The element type T is bf16 or fp16 (the model's dtype, as K1's): the
// products are wgmma's .bf16 or .f16 forms, P and dS are rounded to T
// (fp16's subnormals kept, as the JAX cast keeps them) and the gradients
// are stored in T; the scores, LSE, Di and the accumulators are fp32.
//
// At fp32 (a float32 model, `--bf16 False` training) kernels of their own,
// fa_bwd_dq_f32_kernel and fa_bwd_dkv_f32_kernel below, compute the same
// functions with every product in 3xTF32 and P and dS kept fp32; the C
// entries pick them by the dtype code.
//
// Layouts (the JAX package's public layout): q, dO [B, Lq, H, D];
// k, v [B, S, Hkv, D], all of type T (bf16, fp16 or fp32) and
// contiguous; LSE, Di fp32 [B, H, Lq]; segment ids int32 [B, Lq] /
// [B, S]; dq [B, Lq, H, D], dk/dv [B, S, Hkv, D] T.  GQA: kv head =
// h / (H / Hkv).  D in {64, 128}.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 128;     // rows a block owns: two warpgroups of 64
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBox = 64;       // 2-byte columns per TMA box: the 128-byte swizzle span
constexpr int kHalf = 64 * 128;  // bytes of one 64-row, 64-column box
constexpr float kLog2e = 1.4426950408889634f;
// K3's kv rows per tile, timed against the other length by
// scripts/torch_kernel_ab.py from a copy of this file.
constexpr int kBlockN = 64;
static_assert(kBlockN == 64 || kBlockN == 128, "kv tile of 64 or 128 rows");
constexpr int kStagesDq = kBlockN == 64 ? 4 : 2;  // ring depth in ~128 KB
constexpr int kBlockQ = 64;    // K4's q rows per tile
constexpr int kStagesDkv = 4;

// Shared memory of K3's block, in bytes from a 1024-aligned base.  Q and dO
// are [2 halves][D/64 boxes][64 rows][128 B]; each K or V stage is
// [D/64 boxes][BN rows][128 B].
template <int D>
struct SmemDq {
  static constexpr int BN = kBlockN;
  static constexpr int kStages = kStagesDq;
  static constexpr int kBoxes = D / kBox;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kRows * D * 2;
  static constexpr int kKVBytes = BN * D * 2;
  static constexpr int kK = kDO + kRows * D * 2;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kSeg = kV + kStages * kKVBytes;   // int [kStages][BN]
  static constexpr int kInfo = kSeg + kStages * BN * 4;   // int [kStages][2]
  static constexpr int kLive = kInfo + kStages * 2 * 4;   // int [2][4]
  static constexpr int kBar = kLive + 8 * 4;              // q, full[], empty[]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// Shared memory of K4's block.  K and V are [2 halves][D/64 boxes][64 rows]
// [128 B]; each Q or dO stage is [D/64 boxes][BQ rows][128 B].
template <int D>
struct SmemDkv {
  static constexpr int BQ = kBlockQ;
  static constexpr int kStages = kStagesDkv;
  static constexpr int kBoxes = D / kBox;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kRows * D * 2;
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kQ = kV + kRows * D * 2;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kSeg = kDO + kStages * kQBytes;   // int [kStages][BQ]
  static constexpr int kLse = kSeg + kStages * BQ * 4;    // float [kStages][BQ]
  static constexpr int kDi = kLse + kStages * BQ * 4;     // float [kStages][BQ]
  static constexpr int kInfo = kDi + kStages * BQ * 4;    // int [kStages][2]
  static constexpr int kLive = kInfo + kStages * 2 * 4;   // int [2][4]
  static constexpr int kBar = kLive + 8 * 4;              // kv, full[], empty[]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Whether any of the 64 rows of warpgroup `cw` is valid, given this warp's
// answer: the four warps meet on named barrier 1 + cw.
__device__ __forceinline__ bool warpgroup_any(bool mine, int* flags, int cw,
                                              int warp, int lane) {
  const bool warp_any = __any_sync(0xffffffffu, mine);
  if (lane == 0) flags[cw * 4 + warp] = warp_any;
  bar_sync(1 + cw, 128);
  return flags[cw * 4] | flags[cw * 4 + 1] | flags[cw * 4 + 2] |
         flags[cw * 4 + 3];
}

// Zeros into rows [r0, min(r0 + kRows, L)) of head `head` of a
// [B][L][heads][D] tensor of 2-byte elements, 16 bytes a store: the
// gradient of a block whose own rows are all padding (zero bits are 0 in
// bf16 and fp16 alike).
template <int D>
__device__ __forceinline__ void zero_rows(uint16_t* base, int b, int L,
                                          int heads, int head, int r0,
                                          int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = r0 + i / kChunks;
    if (r < L)
      *reinterpret_cast<uint4*>(
          base + (((long)b * L + r) * heads + head) * D + (i % kChunks) * 8) =
          make_uint4(0, 0, 0, 0);
  }
}

// A 64 x D fp32 accumulator of this warpgroup, rounded to T, into the
// swizzled 64-row box layout at `tile` ([D/64 boxes][64 rows][128 B]).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(uint8_t* tile, const float* acc,
                                           int warp, int g, int c4) {
  const int row0 = warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int box = dt / 8, col = (dt % 8) * 8 + c4 * 2;
    uint8_t* base = tile + box * kHalf;
    *reinterpret_cast<uint32_t*>(base + sw128_offset(row0, col)) =
        pack2<T>(acc[dt * 4 + 0], acc[dt * 4 + 1]);
    *reinterpret_cast<uint32_t*>(base + sw128_offset(row1, col)) =
        pack2<T>(acc[dt * 4 + 2], acc[dt * 4 + 3]);
  }
}

// ---------------------------------------------------------------------------
// K3: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdq,
                 uint16_t* __restrict__ dq_out,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, int H, int Hkv, int Lq,
                 int S, float sm_scale, float scale_log2, int causal,
                 int q_offset, int n_qtiles, int mask_all) {
  using L = SmemDq<D>;
  constexpr int BN = kBlockN;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sbase = smem_addr(smem);
  int* sSeg = reinterpret_cast<int*>(smem + L::kSeg);
  int* sInfo = reinterpret_cast<int*>(smem + L::kInfo);
  const uint32_t bar_q = sbase + L::kBar;
  const uint32_t bar_full = bar_q + 8;                   // + 8 * stage
  const uint32_t bar_empty = bar_q + 8 * (1 + kStages);  // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kRows;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;

  int n_tiles = (S + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q_offset + q0 + kRows - 1) / BN + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // every producer lane arrives
      mbar_init(bar_empty + 8 * s, 8);  // every consumer warp arrives
    }
    fence_barrier_init();
  }
  if (!__syncthreads_or(tid < kRows && q0 + tid < Lq &&
                        q_seg[(long)b * Lq + q0 + tid] != 0)) {
    zero_rows<D>(dq_out, b, Lq, H, h, q0, tid);  // 128 padding rows
    return;
  }

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<24>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        prefetch_tensormap(&tq);
        prefetch_tensormap(&tdo);
        prefetch_tensormap(&tk);
        prefetch_tensormap(&tv);
        mbar_arrive_expect_tx(bar_q, 2 * kRows * D * 2);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            const uint32_t off = (half * L::kBoxes + c) * kHalf;
            tma_load_3d(sbase + L::kQ + off, &tq, bar_q, h * D + c * kBox,
                        q0 + half * 64, b);
            tma_load_3d(sbase + L::kDO + off, &tdo, bar_q, h * D + c * kBox,
                        q0 + half * 64, b);
          }
      }
      // this lane's kv segment ids of the next tile, fetched while the
      // ring is full
      int seg_r[BN / 32];
      auto fetch = [&](int j) {
#pragma unroll
        for (int u = 0; u < BN / 32; ++u) {
          const int r = j * BN + lane + 32 * u;
          seg_r[u] = r < S ? kv_seg[(long)b * S + r] : 0;
        }
      };
      fetch(0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int k0 = j * BN;
        int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
        for (int u = 0; u < BN / 32; ++u) {
          mn = min(mn, seg_r[u]);
          mx = max(mx, seg_r[u]);
        }
        mn = warp_min(mn);
        mx = warp_max(mx);
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < BN / 32; ++u)
          sSeg[s * BN + lane + 32 * u] = seg_r[u];
        if (j + 1 < n_tiles) fetch(j + 1);
        if (lane == 0) {
          sInfo[2 * s] = mn;
          sInfo[2 * s + 1] = mx;
          if (mn == 0 && mx == 0) {  // all padding: nobody reads the tile
            mbar_arrive(bar_full + 8 * s);
            continue;
          }
          mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kKVBytes);
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load_3d(sbase + L::kK + s * L::kKVBytes + c * BN * 128, &tk,
                        bar_full + 8 * s, hk * D + c * kBox, k0, b);
            tma_load_3d(sbase + L::kV + s * L::kKVBytes + c * BN * 128, &tv,
                        bar_full + 8 * s, hk * D + c * kBox, k0, b);
          }
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<240>();
    const int cw = tid / 128 - 1;  // which 64 rows of the q tile
    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4;   // accumulator row within the warp's 8
    const int c4 = lane % 4;  // accumulator column pair
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    const long row_base = ((long)b * H + h) * Lq;
    const int seg0 = r0 < Lq ? q_seg[(long)b * Lq + r0] : 0;
    const int seg1 = r1 < Lq ? q_seg[(long)b * Lq + r1] : 0;
    const float lse0 = r0 < Lq ? lse[row_base + r0] * kLog2e : 0.f;
    const float lse1 = r1 < Lq ? lse[row_base + r1] * kLog2e : 0.f;
    const float di0 = r0 < Lq ? di[row_base + r0] : 0.f;
    const float di1 = r1 < Lq ? di[row_base + r1] : 0.f;
    const int q_mn = warp_min(min(seg0, seg1));
    const int q_mx = warp_max(max(seg0, seg1));
    const int pos0 = q_offset + r0, pos1 = q_offset + r1;
    const int warp_pos = q_offset + q0 + cw * 64 + warp * 16;  // its first row
    int n_mine = n_tiles;  // kv tiles these 64 rows read
    if (causal) n_mine = min(n_tiles, (q_offset + q0 + cw * 64 + 63) / BN + 1);
    // a warpgroup of padding rows has dQ = 0 and reads no tile
    if (!warpgroup_any(seg0 != 0 || seg1 != 0,
                       reinterpret_cast<int*>(smem + L::kLive), cw, warp,
                       lane))
      n_mine = 0;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float sc[BN / 2];           // S of the tile, then P in fp32
    float dp[BN / 2];           // dP of the tile, then dS
    uint32_t da[BN / 16][4];    // dS in T: the A fragments of dS.K
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) da[i][0] = da[i][1] = da[i][2] = da[i][3] = 0u;
    const uint32_t q_tile = sbase + L::kQ + cw * L::kBoxes * kHalf;
    const uint32_t do_tile = sbase + L::kDO + cw * L::kBoxes * kHalf;

    // S = Q K^T and dP = dO V^T of the tile in stage s, 64 x BN each, 16
    // columns of D per step (issued, not waited for).
    auto issue_s = [&](int s) {
      const uint32_t k_tile = sbase + L::kK + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;  // box, 32-byte step inside it
        wgmma_ss<T, BN>(sc, sw128_desc(q_tile + c * kHalf + w * 32, 16, 1024),
                     sw128_desc(k_tile + c * BN * 128 + w * 32, 16, 1024),
                     kk > 0);
      }
    };
    auto issue_dp = [&](int s) {
      const uint32_t v_tile = sbase + L::kV + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;
        wgmma_ss<T, BN>(dp, sw128_desc(do_tile + c * kHalf + w * 32, 16, 1024),
                     sw128_desc(v_tile + c * BN * 128 + w * 32, 16, 1024),
                     kk > 0);
      }
    };
    // dQ += dS K: K of stage s is the MN-major B operand (16 kv rows a step).
    auto issue_dq = [&](int s) {
      const uint32_t k_tile = sbase + L::kK + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb<T, D>(dq, da[kk],
                       sw128_desc(k_tile + kk * 16 * 128, BN * 128, 1024));
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    };

    mbar_wait(bar_q, 0);
    int pending = -1;  // stage whose dS.K is still in flight
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      const int k_mn = sInfo[2 * s], k_mx = sInfo[2 * s + 1];
      if (j >= n_mine || (k_mn == 0 && k_mx == 0)) {  // nothing to see
        if (pending >= 0) {  // a run of skipped tiles must not hold the ring
          wgmma_wait<0>();
          fence_regs(dq);
          fence_regs(da);
          release(pending);
          pending = -1;
        }
        release(s);
        continue;
      }
      const int k0 = j * BN;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      issue_dp(s);
      wgmma_commit();
      fence_regs(sc);
      fence_regs(dp);
      wgmma_wait<1>();  // S of this tile, and dS.K of the last one
      fence_regs(sc);
      fence_regs(dq);
      fence_regs(da);
      if (pending >= 0) release(pending);
      // P = where(mask, exp2(S scale log2(e) - LSE log2(e)), 0)
      const bool interior = !mask_all && k_mn != 0 && k_mn == k_mx &&
                            q_mn == k_mn && q_mx == k_mn &&
                            (!causal || k0 + BN - 1 <= warp_pos);
      if (interior) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          sc[nt * 4 + 0] = exp2f(fmaf(sc[nt * 4 + 0], scale_log2, -lse0));
          sc[nt * 4 + 1] = exp2f(fmaf(sc[nt * 4 + 1], scale_log2, -lse0));
          sc[nt * 4 + 2] = exp2f(fmaf(sc[nt * 4 + 2], scale_log2, -lse1));
          sc[nt * 4 + 3] = exp2f(fmaf(sc[nt * 4 + 3], scale_log2, -lse1));
        }
      } else {
        const int* seg = sSeg + s * BN;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + c4 * 2 + e;
            const int kseg = seg[col];
            const int kpos = k0 + col;
            const bool ok0 =
                kseg != 0 && kseg == seg0 && (!causal || pos0 >= kpos);
            const bool ok1 =
                kseg != 0 && kseg == seg1 && (!causal || pos1 >= kpos);
            const float p0 = exp2f(fmaf(sc[nt * 4 + e], scale_log2, -lse0));
            const float p1 =
                exp2f(fmaf(sc[nt * 4 + 2 + e], scale_log2, -lse1));
            sc[nt * 4 + e] = ok0 ? p0 : 0.f;
            sc[nt * 4 + 2 + e] = ok1 ? p1 : 0.f;
          }
        }
      }
      wgmma_wait<0>();  // dP of this tile
      fence_regs(dp);
      // dS = P (dP - Di) scale, then to T (the JAX kernel's _gemm2_cast)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        dp[nt * 4 + 0] = sc[nt * 4 + 0] * (dp[nt * 4 + 0] - di0) * sm_scale;
        dp[nt * 4 + 1] = sc[nt * 4 + 1] * (dp[nt * 4 + 1] - di0) * sm_scale;
        dp[nt * 4 + 2] = sc[nt * 4 + 2] * (dp[nt * 4 + 2] - di1) * sm_scale;
        dp[nt * 4 + 3] = sc[nt * 4 + 3] * (dp[nt * 4 + 3] - di1) * sm_scale;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        da[kk][0] = pack2<T>(dp[8 * kk + 0], dp[8 * kk + 1]);
        da[kk][1] = pack2<T>(dp[8 * kk + 2], dp[8 * kk + 3]);
        da[kk][2] = pack2<T>(dp[8 * kk + 4], dp[8 * kk + 5]);
        da[kk][3] = pack2<T>(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
      fence_regs(da);
      fence_regs(dq);
      wgmma_fence();
      issue_dq(s);
      wgmma_commit();
      fence_regs(dq);
      fence_regs(da);
      pending = s;
    }
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    if (pending >= 0) release(pending);

    // dQ of these 64 rows in T through this warpgroup's own Q tile
    // (no other warpgroup reads it), out by TMA stores.
    bar_sync(1 + cw, 128);  // every warp's products are done with Q
    stage_rows<T, D>(smem + L::kQ + cw * L::kBoxes * kHalf, dq, warp, g, c4);
    fence_proxy_async();
    bar_sync(1 + cw, 128);
    if (t == 0 && q0 + cw * 64 < Lq) {
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c)
        tma_store_3d(&tdq, q_tile + c * kHalf, h * D + c * kBox,
                     q0 + cw * 64, b);
      tma_store_commit_and_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// K4: dK, dV
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdk,
                  const __grid_constant__ CUtensorMap tdv,
                  uint16_t* __restrict__ dk_out,
                  uint16_t* __restrict__ dv_out,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  const int* __restrict__ q_seg,
                  const int* __restrict__ kv_seg, int H, int Hkv, int Lq,
                  int S, float sm_scale, float scale_log2, int causal,
                  int q_offset, int mask_all) {
  using L = SmemDkv<D>;
  constexpr int BQ = kBlockQ;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sbase = smem_addr(smem);
  int* sSeg = reinterpret_cast<int*>(smem + L::kSeg);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDi = reinterpret_cast<float*>(smem + L::kDi);
  int* sInfo = reinterpret_cast<int*>(smem + L::kInfo);
  const uint32_t bar_kv = sbase + L::kBar;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_kv + 8 * (1 + kStages);

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  // kv tile 0 is seen by every q row (causal): the heaviest blocks first
  const int k0 = static_cast<int>(blockIdx.z) * kRows;
  const int group = H / Hkv;
  const int tid = threadIdx.x;

  const int n_qtiles = (Lq + BQ - 1) / BQ;
  // first q tile whose last row can see kv row k0 (causal):
  // q_offset + q0 + BQ - 1 >= k0
  const int first = causal ? min(max(k0 - q_offset, 0) / BQ, n_qtiles) : 0;
  const int per_head = n_qtiles - first;
  const int n_tiles = group * per_head;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, 8);
    }
    fence_barrier_init();
  }
  if (!__syncthreads_or(tid < kRows && k0 + tid < S &&
                        kv_seg[(long)b * S + k0 + tid] != 0)) {
    zero_rows<D>(dk_out, b, S, Hkv, hk, k0, tid);  // 128 padding rows
    zero_rows<D>(dv_out, b, S, Hkv, hk, k0, tid);
    return;
  }

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<24>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        prefetch_tensormap(&tk);
        prefetch_tensormap(&tv);
        prefetch_tensormap(&tq);
        prefetch_tensormap(&tdo);
        mbar_arrive_expect_tx(bar_kv, 2 * kRows * D * 2);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            const uint32_t off = (half * L::kBoxes + c) * kHalf;
            tma_load_3d(sbase + L::kK + off, &tk, bar_kv, hk * D + c * kBox,
                        k0 + half * 64, b);
            tma_load_3d(sbase + L::kV + off, &tv, bar_kv, hk * D + c * kBox,
                        k0 + half * 64, b);
          }
      }
      // this lane's rows of the next q tile (segment id, LSE log2(e), Di),
      // fetched while the ring is full
      int seg_r[BQ / 32];
      float lse_r[BQ / 32], di_r[BQ / 32];
      auto fetch = [&](int j) {
        const int h = hk * group + j / per_head;
        const int q0 = (first + j % per_head) * BQ;
        const long row_base = ((long)b * H + h) * Lq;
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          const int r = q0 + lane + 32 * u;
          const bool in = r < Lq;
          seg_r[u] = in ? q_seg[(long)b * Lq + r] : 0;
          lse_r[u] = in ? lse[row_base + r] * kLog2e : 0.f;
          di_r[u] = in ? di[row_base + r] : 0.f;
        }
      };
      if (n_tiles > 0) fetch(0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int h = hk * group + j / per_head;
        const int q0 = (first + j % per_head) * BQ;
        int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          mn = min(mn, seg_r[u]);
          mx = max(mx, seg_r[u]);
        }
        mn = warp_min(mn);
        mx = warp_max(mx);
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          sSeg[s * BQ + lane + 32 * u] = seg_r[u];
          sLse[s * BQ + lane + 32 * u] = lse_r[u];
          sDi[s * BQ + lane + 32 * u] = di_r[u];
        }
        if (j + 1 < n_tiles) fetch(j + 1);
        if (lane == 0) {
          sInfo[2 * s] = mn;
          sInfo[2 * s + 1] = mx;
          if (mn == 0 && mx == 0) {  // all padding: nobody reads the tile
            mbar_arrive(bar_full + 8 * s);
            continue;
          }
          mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kQBytes);
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load_3d(sbase + L::kQ + s * L::kQBytes + c * BQ * 128, &tq,
                        bar_full + 8 * s, h * D + c * kBox, q0, b);
            tma_load_3d(sbase + L::kDO + s * L::kQBytes + c * BQ * 128, &tdo,
                        bar_full + 8 * s, h * D + c * kBox, q0, b);
          }
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<240>();
    const int cw = tid / 128 - 1;  // which 64 kv rows of the block
    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int kv_w0 = k0 + cw * 64;  // first kv row of this warpgroup
    const int r0 = kv_w0 + warp * 16 + g;  // the kv rows of this thread
    const int r1 = r0 + 8;
    const int kseg0 = r0 < S ? kv_seg[(long)b * S + r0] : 0;
    const int kseg1 = r1 < S ? kv_seg[(long)b * S + r1] : 0;
    const int k_mn = warp_min(min(kseg0, kseg1));
    const int k_mx = warp_max(max(kseg0, kseg1));
    const int warp_last = kv_w0 + warp * 16 + 15;  // its last kv row
    // a warpgroup of padding rows has dK = dV = 0 and reads no tile
    const bool live = warpgroup_any(kseg0 != 0 || kseg1 != 0,
                                    reinterpret_cast<int*>(smem + L::kLive),
                                    cw, warp, lane);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float sc[BQ / 2];         // S^T of the tile, then P^T in fp32
    float dp[BQ / 2];         // dP^T of the tile, then dS^T
    uint32_t pa[BQ / 16][4];  // P^T in T: the A fragments of P^T.dO
    uint32_t da[BQ / 16][4];  // dS^T in T: the A fragments of dS^T.Q
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[i][e] = da[i][e] = 0u;
    const uint32_t k_tile = sbase + L::kK + cw * L::kBoxes * kHalf;
    const uint32_t v_tile = sbase + L::kV + cw * L::kBoxes * kHalf;

    // S^T = K Q^T and dP^T = V dO^T of the tile in stage s, 64 x BQ each.
    auto issue_s = [&](int s) {
      const uint32_t q_tile = sbase + L::kQ + s * L::kQBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;
        wgmma_ss<T, BQ>(sc, sw128_desc(k_tile + c * kHalf + w * 32, 16, 1024),
                     sw128_desc(q_tile + c * BQ * 128 + w * 32, 16, 1024),
                     kk > 0);
      }
    };
    auto issue_dp = [&](int s) {
      const uint32_t do_tile = sbase + L::kDO + s * L::kQBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;
        wgmma_ss<T, BQ>(dp, sw128_desc(v_tile + c * kHalf + w * 32, 16, 1024),
                     sw128_desc(do_tile + c * BQ * 128 + w * 32, 16, 1024),
                     kk > 0);
      }
    };
    // dV += P^T dO and dK += dS^T Q: dO and Q of stage s are the MN-major
    // B operands (16 q rows a step).
    auto issue_dv = [&](int s) {
      const uint32_t do_tile = sbase + L::kDO + s * L::kQBytes;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_tb<T, D>(dv, pa[kk],
                       sw128_desc(do_tile + kk * 16 * 128, BQ * 128, 1024));
    };
    auto issue_dk = [&](int s) {
      const uint32_t q_tile = sbase + L::kQ + s * L::kQBytes;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_tb<T, D>(dk, da[kk],
                       sw128_desc(q_tile + kk * 16 * 128, BQ * 128, 1024));
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    };

    mbar_wait(bar_kv, 0);
    // Per tile: S^T and dP^T issued together; P^T from S^T while the
    // tensor cores do dP^T; dS^T; then dV and dK issued together, dK left
    // in flight across the next tile's S^T and dP^T.  Only dS^T's
    // fragments stay live across tiles, and P^T's T fragments are made
    // after dS^T: the accumulators and one tile's scores fill the 240
    // registers (dV issued before dS^T, to overlap it, held 16 more and
    // ran slower).
    int pending = -1;  // stage whose dK product is still in flight
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      const int q0 = (first + j % per_head) * BQ;
      const int q_mn = sInfo[2 * s], q_mx = sInfo[2 * s + 1];
      if (!live || (q_mn == 0 && q_mx == 0) ||
          (causal && q_offset + q0 + BQ - 1 < kv_w0)) {  // nothing to see
        if (pending >= 0) {  // a run of skipped tiles must not hold the ring
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(da);
          release(pending);
          pending = -1;
        }
        release(s);
        continue;
      }
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      issue_dp(s);
      wgmma_commit();
      fence_regs(sc);
      fence_regs(dp);
      wgmma_wait<1>();  // S^T of this tile, and dK of the last one
      fence_regs(sc);
      fence_regs(dk);
      fence_regs(da);
      if (pending >= 0) release(pending);
      // P^T = where(mask, exp2(S^T scale log2(e) - LSE log2(e)), 0): rows
      // are kv, columns q.
      const float* lse2 = sLse + s * BQ;
      const bool interior = !mask_all && q_mn != 0 && q_mn == q_mx &&
                            k_mn == q_mn && k_mx == q_mn &&
                            (!causal || q_offset + q0 >= warp_last);
      if (interior) {
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          const float2 l =
              *reinterpret_cast<const float2*>(lse2 + nt * 8 + c4 * 2);
          sc[nt * 4 + 0] = exp2f(fmaf(sc[nt * 4 + 0], scale_log2, -l.x));
          sc[nt * 4 + 1] = exp2f(fmaf(sc[nt * 4 + 1], scale_log2, -l.y));
          sc[nt * 4 + 2] = exp2f(fmaf(sc[nt * 4 + 2], scale_log2, -l.x));
          sc[nt * 4 + 3] = exp2f(fmaf(sc[nt * 4 + 3], scale_log2, -l.y));
        }
      } else {
        const int* qs = sSeg + s * BQ;
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          const int col = nt * 8 + c4 * 2;
          const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
          const int2 qseg = *reinterpret_cast<const int2*>(qs + col);
          const int qpos = q_offset + q0 + col;
          const bool ok00 = kseg0 != 0 && qseg.x == kseg0 &&
                            (!causal || qpos >= r0);
          const bool ok01 = kseg0 != 0 && qseg.y == kseg0 &&
                            (!causal || qpos + 1 >= r0);
          const bool ok10 = kseg1 != 0 && qseg.x == kseg1 &&
                            (!causal || qpos >= r1);
          const bool ok11 = kseg1 != 0 && qseg.y == kseg1 &&
                            (!causal || qpos + 1 >= r1);
          const float p00 = exp2f(fmaf(sc[nt * 4 + 0], scale_log2, -l.x));
          const float p01 = exp2f(fmaf(sc[nt * 4 + 1], scale_log2, -l.y));
          const float p10 = exp2f(fmaf(sc[nt * 4 + 2], scale_log2, -l.x));
          const float p11 = exp2f(fmaf(sc[nt * 4 + 3], scale_log2, -l.y));
          sc[nt * 4 + 0] = ok00 ? p00 : 0.f;
          sc[nt * 4 + 1] = ok01 ? p01 : 0.f;
          sc[nt * 4 + 2] = ok10 ? p10 : 0.f;
          sc[nt * 4 + 3] = ok11 ? p11 : 0.f;
        }
      }
      wgmma_wait<0>();  // dP^T of this tile
      fence_regs(dp);
      // dS^T = P^T (dP^T - Di) scale; then P^T and dS^T to T
      const float* dis = sDi + s * BQ;
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 d =
            *reinterpret_cast<const float2*>(dis + nt * 8 + c4 * 2);
        dp[nt * 4 + 0] = sc[nt * 4 + 0] * (dp[nt * 4 + 0] - d.x) * sm_scale;
        dp[nt * 4 + 1] = sc[nt * 4 + 1] * (dp[nt * 4 + 1] - d.y) * sm_scale;
        dp[nt * 4 + 2] = sc[nt * 4 + 2] * (dp[nt * 4 + 2] - d.x) * sm_scale;
        dp[nt * 4 + 3] = sc[nt * 4 + 3] * (dp[nt * 4 + 3] - d.y) * sm_scale;
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        pa[kk][0] = pack2<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
        da[kk][0] = pack2<T>(dp[8 * kk + 0], dp[8 * kk + 1]);
        da[kk][1] = pack2<T>(dp[8 * kk + 2], dp[8 * kk + 3]);
        da[kk][2] = pack2<T>(dp[8 * kk + 4], dp[8 * kk + 5]);
        da[kk][3] = pack2<T>(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      issue_dv(s);
      wgmma_commit();
      issue_dk(s);
      wgmma_commit();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_wait<1>();  // dV of this tile (dK left in flight)
      fence_regs(dv);
      fence_regs(pa);
      pending = s;
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(da);
    if (pending >= 0) release(pending);

    // dK and dV of these 64 rows in T through this warpgroup's own K and
    // V tiles (no other warpgroup reads them), out by TMA stores.
    bar_sync(1 + cw, 128);  // every warp's products are done with K, V
    stage_rows<T, D>(smem + L::kK + cw * L::kBoxes * kHalf, dk, warp, g, c4);
    stage_rows<T, D>(smem + L::kV + cw * L::kBoxes * kHalf, dv, warp, g, c4);
    fence_proxy_async();
    bar_sync(1 + cw, 128);
    if (t == 0 && kv_w0 < S) {
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_store_3d(&tdk, k_tile + c * kHalf, hk * D + c * kBox, kv_w0, b);
        tma_store_3d(&tdv, v_tile + c * kHalf, hk * D + c * kBox, kv_w0, b);
      }
      tma_store_commit_and_wait();
    }
  }
}

// ------------------------------------------------------------------- fp32
// The fp32 kernels: K3 and K4 at fp32 operands, as the JAX kernels compute
// them (dots at fp32 with fp32 accumulation, _gemm2_cast the identity: P
// and dS stay fp32 in the second products), every product 3xTF32 on the
// tensor cores (csrc/tf32x3.cuh).  Bounded by operations: three tf32
// products for each fp32 one.
// K3 (simple first, through mma.sync): one block per (128-row q tile, q
// head, batch row), eight warps of 16 rows, no warp specialization, no
// TMA; Q and dO are loaded once and K and V stream in 32-row tiles through
// two stages of cp.async; every element goes through the mask (`mask_all`
// changes nothing).  S = Q K^T and dP = dO V^T per kv tile, dS in
// registers, dQ += dS K.
// K4 (on wgmma, below): S^T = K Q^T and dP^T = V dO^T per q tile of every
// q head of the GQA group (from the first that can see the block's rows),
// dV += P^T dO and dK += dS^T Q, the group summed in the fp32 accumulators.
constexpr int kRowsF32 = 128;  // the block's own rows: eight warps of 16
constexpr int kTileF32 = 32;   // rows of a streamed tile
constexpr int kThreadsF32 = 256;

// Shared memory of K3's fp32 block, in bytes: row-major fp32 tiles of row
// stride D + 4 (tf32x3.cuh).  The block's own two tiles (Q, dO), then two
// stages of the two streamed tiles (K, V) with their rows' segment ids.
template <int D>
struct SmemF32 {
  static constexpr int kLd = tf32x3::stride<D>();
  static constexpr int kOwn = kRowsF32 * kLd * 4;
  static constexpr int kTile = kTileF32 * kLd * 4;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kOwn;
  static constexpr int kS0 = kB + kOwn;         // [2 stages]
  static constexpr int kS1 = kS0 + 2 * kTile;   // [2 stages]
  static constexpr int kSeg = kS1 + 2 * kTile;  // int [2][kTileF32]
  static constexpr int kBytes = kSeg + 2 * kTileF32 * 4;
};
static_assert(SmemF32<128>::kBytes <= 232448, "one fp32 block fits an SM");

// Rows r0 and r0 + 8 of this warp's 16 x D accumulator into head `head` of
// a [B][L][heads][D] fp32 tensor, rows past L dropped.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[D / 8][4],
                                               int b, int L, int heads,
                                               int head, int r0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= L) continue;
    float* row = out + (((long)b * L + r) * heads + head) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(row + dt * 8) =
          make_float2(acc[dt][2 * half], acc[dt][2 * half + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32, 1)
fa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, float* __restrict__ dq,
                     int H, int Hkv, int Lq, int S, float sm_scale,
                     float scale_log2, int causal, int q_offset,
                     int n_qtiles) {
  using L = SmemF32<D>;
  constexpr int BN = kTileF32;
  extern __shared__ __align__(16) uint8_t smem_f32[];
  const uint32_t sbase = smem_addr(smem_f32);
  const uint8_t* smem = smem_f32;
  auto tile = [=](int off) {
    return reinterpret_cast<const float*>(smem + off);
  };
  int* sSeg = reinterpret_cast<int*>(smem_f32 + L::kSeg);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kRowsF32;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  int n_tiles = (S + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q_offset + q0 + kRowsF32 - 1) / BN + 1);

  auto load_tile = [&](int j) {  // K, V and kv segment ids into stage j % 2
    const int s = j & 1, k0 = j * BN;
    tf32x3::load_rows<BN, D>(sbase + L::kS0 + s * L::kTile, k, b, S, Hkv, hk,
                             k0, tid, kThreadsF32);
    tf32x3::load_rows<BN, D>(sbase + L::kS1 + s * L::kTile, v, b, S, Hkv, hk,
                             k0, tid, kThreadsF32);
    for (int i = tid; i < BN; i += kThreadsF32)
      sSeg[s * BN + i] = k0 + i < S ? kv_seg[(long)b * S + k0 + i] : 0;
  };
  tf32x3::load_rows<kRowsF32, D>(sbase + L::kA, q, b, Lq, H, h, q0, tid,
                                 kThreadsF32);
  tf32x3::load_rows<kRowsF32, D>(sbase + L::kB, dout, b, Lq, H, h, q0, tid,
                                 kThreadsF32);
  load_tile(0);
  tf32x3::cp_async_commit();

  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const long row_base = ((long)b * H + h) * Lq;
  const int seg0 = r0 < Lq ? q_seg[(long)b * Lq + r0] : 0;
  const int seg1 = r1 < Lq ? q_seg[(long)b * Lq + r1] : 0;
  const float lse0 = r0 < Lq ? lse[row_base + r0] * kLog2e : 0.f;
  const float lse1 = r1 < Lq ? lse[row_base + r1] * kLog2e : 0.f;
  const float di0 = r0 < Lq ? di[row_base + r0] : 0.f;
  const float di1 = r1 < Lq ? di[row_base + r1] : 0.f;
  const int pos0 = q_offset + r0, pos1 = q_offset + r1;

  float acc[D / 8][4];
  tf32x3::zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(j + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const int s = j & 1, k0 = j * BN;
    const float* sK = tile(L::kS0 + s * L::kTile);
    const float* sV = tile(L::kS1 + s * L::kTile);
    const int* seg = sSeg + s * BN;
    float sc[BN / 8][4], dp[BN / 8][4];
    tf32x3::scores<D>(sc, tile(L::kA), warp * 16, sK, g, t);   // S = Q K^T
    tf32x3::scores<D>(dp, tile(L::kB), warp * 16, sV, g, t);   // dP = dO V^T
    // P = where(mask, exp2(S scale log2(e) - LSE log2(e)), 0), then
    // dS = P (dP - Di) scale into sc
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        const int kseg = seg[col];
        const int kpos = k0 + col;
        const bool ok0 =
            kseg != 0 && kseg == seg0 && (!causal || pos0 >= kpos);
        const bool ok1 =
            kseg != 0 && kseg == seg1 && (!causal || pos1 >= kpos);
        const float p0 = ok0 ? exp2f(sc[nt][e] * scale_log2 - lse0) : 0.f;
        const float p1 =
            ok1 ? exp2f(sc[nt][2 + e] * scale_log2 - lse1) : 0.f;
        sc[nt][e] = p0 * (dp[nt][e] - di0) * sm_scale;
        sc[nt][2 + e] = p1 * (dp[nt][2 + e] - di1) * sm_scale;
      }
    }
    tf32x3::accumulate<D, BN / 8, 8>(acc, sc, sK, g, t);  // dQ += dS K
    __syncthreads();  // stage s is free for tile j + 2
  }
  store_rows_f32<D>(dq, acc, b, Lq, H, h, r0, t);
}

// K4 at fp32, on wgmma: every product 3xTF32 from TMA-fed shared memory,
// each operand split once (csrc/tf32x3.cuh).  Shared memory decides the
// shape: at D = 128 a 64-row fp32 tile is 32 KB, and wgmma's tf32 form
// reads both shared-memory operands K-major only, so Q and dO would be
// needed twice (rows for S^T and dP^T, transposed for dK and dV), hi and
// lo, with K and V hi and lo beside them: more than an SM holds.  So:
//   - one block per (64-row kv tile, kv head, batch row), 384 threads:
//     warp 0 issues the TMA loads, warps 1-3 split each streamed tile in
//     place (hi over x, lo beside it); warpgroup 1 computes S^T, P^T, dS^T
//     and dK, warpgroup 2 dP^T and dV;
//   - K and V are loaded once; warpgroup 1 splits K (hi in place, lo into
//     its registers: the register A operand of K_lo Q_hi^T), warpgroup 2
//     V the same way;
//   - Q and dO stream in 32-row tiles (with their rows' segment ids, LSE
//     log2(e) and Di) through a two-stage ring, over every q head of the
//     GQA group from the first q tile that can see the block's rows;
//   - S^T = K Q^T and dP^T = V dO^T run at once, one a warpgroup, m64n32k8;
//     warpgroup 1 turns S^T into P^T (the mask skipped on interior tiles)
//     and writes it split, as a [kv rows][q] tile (the K-major B operand of
//     dV^T = dO^T P); warpgroup 2 writes dP^T whole; warpgroup 1 forms
//     dS^T = P^T (dP^T - Di) scale over it, split (the B operand of
//     dK^T = Q^T dS);
//   - the second products take dO^T and Q^T as register A fragments read
//     by hand from the row tiles (already split), so no transposed Q or dO
//     is kept; each 64-row d block and 32-column kv chunk of a tile's
//     product starts from zero and is added to the running sum in fp32, and
//     the GQA group's sum stays in those accumulators;
//   - one-way named barriers pace the exchange (P^T written; dV done with
//     it; dP^T written; dK done with the dS^T tiles), so that one
//     warpgroup's products run while the other forms P^T or dS^T.
constexpr int kRowsDkvF32 = 64;  // kv rows a block owns
constexpr int kTileQF32 = 32;    // q rows a streamed tile
constexpr int kStagesDkvF32 = 2;
constexpr int kConvertersF32 = 96;  // warps 1-3 split the streamed tiles
// Named barriers of K4's fp32 exchange (1 and 2 are each warpgroup's own;
// each is arrived at by one warpgroup and waited on by the other)
constexpr int kBarPFull = 3;    // P^T written (warpgroup 1 to 2)
constexpr int kBarPFree = 4;    // dV done with P^T (2 to 1)
constexpr int kBarDPFull = 5;   // dP^T written (2 to 1)
constexpr int kBarDPFree = 6;   // dK done with the dS^T tiles (1 to 2)

// Shared memory of K4's fp32 block, in bytes from a 1024-aligned base: K
// and V [D/32 boxes][64 rows][128 B] (hi once split); per stage Q, Q lo,
// dO, dO lo [D/32 boxes][32 rows][128 B]; the exchange P^T hi, P^T lo,
// dS^T hi, dS^T lo (first dP^T), each [64 kv rows][32 q][4 B] swizzled.
template <int D>
struct SmemDkvF32 {
  static constexpr int BQ = kTileQF32;
  static constexpr int kBoxes = D / 32;
  static constexpr int kOwn = kRowsDkvF32 * D * 4;
  static constexpr int kTile = BQ * D * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kOwn;
  static constexpr int kRing = 2 * kOwn;
  static constexpr int kQ = 0, kQlo = kTile, kDO = 2 * kTile,
                       kDOlo = 3 * kTile;  // within a stage
  static constexpr int kStage = 4 * kTile;
  static constexpr int kX = kRing + kStagesDkvF32 * kStage;
  static constexpr int kXTile = kRowsDkvF32 * BQ * 4;
  static constexpr int kPhi = 0, kPlo = kXTile, kShi = 2 * kXTile,
                       kSlo = 3 * kXTile;  // within the exchange
  static constexpr int kSeg = kX + 4 * kXTile;  // int [stages][BQ]
  static constexpr int kLse = kSeg + kStagesDkvF32 * BQ * 4;
  static constexpr int kDi = kLse + kStagesDkvF32 * BQ * 4;
  static constexpr int kInfo = kDi + kStagesDkvF32 * BQ * 4;  // int [stages][2]
  static constexpr int kBar = kInfo + kStagesDkvF32 * 2 * 4;  // kv, full, ready, empty
  static constexpr int kBytes = kBar + (1 + 3 * kStagesDkvF32) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};
static_assert(SmemDkvF32<128>::kAlloc <= 232448, "one fp32 block fits an SM");

// C[64 x 32] = A B^T over D from shared memory (A: 64 own rows, hi in
// place, lo in registers; B: a 32-row streamed tile and its lo), 3xTF32:
// the hi-hi chain into `big`, the cross terms into `small` (S^T = K Q^T,
// dP^T = V dO^T).  Issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void issue_scores(float* big, float* small,
                                             uint32_t own,
                                             const uint32_t (&lo)[D / 8][4],
                                             uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t da =
        sw128_desc(own + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024);
    const uint32_t step = (kk / 4) * kTileQF32 * 128 + (kk % 4) * 32;
    const uint64_t db = sw128_desc(b_hi + step, 16, 1024);
    tf32x3::wgmma_ss32(big, da, db, kk > 0);
    tf32x3::wgmma_rs32(small, lo[kk], db, kk > 0);
    tf32x3::wgmma_ss32(small, da, sw128_desc(b_lo + step, 16, 1024), 1);
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      float* __restrict__ dk_out, float* __restrict__ dv_out,
                      const float* __restrict__ lse,
                      const float* __restrict__ di,
                      const int* __restrict__ q_seg,
                      const int* __restrict__ kv_seg, int H, int Hkv, int Lq,
                      int S, float sm_scale, float scale_log2, int causal,
                      int q_offset, int mask_all) {
  using L = SmemDkvF32<D>;
  constexpr int BQ = kTileQF32;
  constexpr int kStages = kStagesDkvF32;
  constexpr int MB = D / 64;  // 64-row d blocks of dK^T and dV^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sbase = smem_addr(smem);
  int* sSeg = reinterpret_cast<int*>(smem + L::kSeg);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDi = reinterpret_cast<float*>(smem + L::kDi);
  int* sInfo = reinterpret_cast<int*>(smem + L::kInfo);
  const uint32_t bar_kv = sbase + L::kBar;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_ready = bar_full + 8 * kStages;
  const uint32_t bar_empty = bar_ready + 8 * kStages;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  // kv tile 0 is seen by every q row (causal): the heaviest blocks first
  const int k0 = static_cast<int>(blockIdx.z) * kRowsDkvF32;
  const int group = H / Hkv;
  const int tid = threadIdx.x;

  const int n_qtiles = (Lq + BQ - 1) / BQ;
  // first q tile whose last row can see kv row k0 (causal)
  const int first = causal ? min(max(k0 - q_offset, 0) / BQ, n_qtiles) : 0;
  const int per_head = n_qtiles - first;
  const int n_tiles = group * per_head;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_ready + 8 * s, kConvertersF32);
      mbar_init(bar_empty + 8 * s, 8);
    }
    fence_barrier_init();
  }
  if (!__syncthreads_or(tid < kRowsDkvF32 && k0 + tid < S &&
                        kv_seg[(long)b * S + k0 + tid] != 0)) {
    // 64 padding rows: zero gradients
    for (int i = tid; i < kRowsDkvF32 * D; i += kThreads) {
      const int r = k0 + i / D;
      if (r < S) {
        const long at = (((long)b * S + r) * Hkv + hk) * D + i % D;
        dk_out[at] = 0.f;
        dv_out[at] = 0.f;
      }
    }
    return;
  }

  if (tid < 128) {
    reg_dealloc<40>();
    if (tid < 32) {
      // ------------------------------------------------------ producer
      const int lane = tid;
      if (lane == 0) {
        prefetch_tensormap(&tk);
        prefetch_tensormap(&tv);
        prefetch_tensormap(&tq);
        prefetch_tensormap(&tdo);
        mbar_arrive_expect_tx(bar_kv, 2 * L::kOwn);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_3d(sbase + L::kK + c * 64 * 128, &tk, bar_kv, hk * D + c * 32,
                      k0, b);
          tma_load_3d(sbase + L::kV + c * 64 * 128, &tv, bar_kv, hk * D + c * 32,
                      k0, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t st = sbase + L::kRing + s * L::kStage;
        const int h = hk * group + j / per_head;
        const int q0 = (first + j % per_head) * BQ;
        const int r = q0 + lane;
        const bool in = r < Lq;
        const long row = ((long)b * H + h) * Lq + r;
        const int seg = in ? q_seg[(long)b * Lq + r] : 0;
        const float ls = in ? lse[row] * kLog2e : 0.f;
        const float d_i = in ? di[row] : 0.f;
        const int mn = warp_min(seg), mx = warp_max(seg);
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
        sSeg[s * BQ + lane] = seg;
        sLse[s * BQ + lane] = ls;
        sDi[s * BQ + lane] = d_i;
        if (lane == 0) {
          sInfo[2 * s] = mn;
          sInfo[2 * s + 1] = mx;
          if (mn == 0 && mx == 0) {  // all padding: nobody reads the tile
            mbar_arrive(bar_full + 8 * s);
            continue;
          }
          mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kTile);
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load_3d(st + L::kQ + c * BQ * 128, &tq, bar_full + 8 * s,
                        h * D + c * 32, q0, b);
            tma_load_3d(st + L::kDO + c * BQ * 128, &tdo, bar_full + 8 * s,
                        h * D + c * 32, q0, b);
          }
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
    } else {
      // ---------------------------------------------------- converters
      const int ct = tid - 32;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        uint8_t* st = smem + L::kRing + s * L::kStage;
        mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
        if (sInfo[2 * s] != 0 || sInfo[2 * s + 1] != 0) {  // loaded
          tf32x3::split_tile<BQ, D>(st + L::kQ, st + L::kQlo, ct,
                                    kConvertersF32);
          tf32x3::split_tile<BQ, D>(st + L::kDO, st + L::kDOlo, ct,
                                    kConvertersF32);
          fence_proxy_async();
        }
        mbar_arrive(bar_ready + 8 * s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int cw = tid / 128 - 1;  // 0: S^T, P^T, dS^T, dK; 1: dP^T, dV
    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int r0 = k0 + warp * 16 + g;  // the kv rows of this thread
    const int r1 = r0 + 8;
    const int kseg0 = r0 < S ? kv_seg[(long)b * S + r0] : 0;
    const int kseg1 = r1 < S ? kv_seg[(long)b * S + r1] : 0;
    const int k_mn = warp_min(min(kseg0, kseg1));
    const int k_mx = warp_max(max(kseg0, kseg1));
    const int warp_last = k0 + warp * 16 + 15;  // its last kv row
    uint8_t* x = smem + L::kX;
    const uint32_t xs = sbase + L::kX;

    mbar_wait(bar_kv, 0);
    uint32_t own_lo[D / 8][4];
    tf32x3::split_rows<D>(smem + (cw == 0 ? L::kK : L::kV), own_lo, warp,
                          g, c4);
    fence_proxy_async();
    bar_sync(1 + cw, 128);  // the warpgroup's K or V hi in place
    const uint32_t own = sbase + (cw == 0 ? L::kK : L::kV);

    // dK^T (warpgroup 1) or dV^T (warpgroup 2): d rows 64 m + (0..63) by
    // kv columns 32 c + (0..31), in the m64n32 layout
    float acc[MB][2][16];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[m][c][i] = 0.f;
    // Byte offsets in a row tile ([D/32 boxes][32 q rows][128 B]) of this
    // thread's A fragment of dO^T or Q^T at d block 0, k step 0: a0 (d0,
    // q c4), a1 (d0 + 8, c4), a2 (d0, c4 + 4), a3 (d0 + 8, c4 + 4); k step
    // kk adds 8 rows (1,024 bytes), d block m two boxes.
    uint32_t a_off[4];
    {
      const int d0 = warp * 16 + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + (i & 1) * 8, q = c4 + (i >> 1) * 4;
        a_off[i] = (d / 32) * BQ * 128 + tf32x3::sw128_f32(q, d % 32);
      }
    }

    // acc += (A^T B), A^T the register fragments of the row tile `rows`
    // (hi) and `rows_lo`, read by hand, B the exchange tile `bh` / `bl`
    // ([64 kv rows][32 q], K-major): each d block and 32-column chunk from
    // zero (hi-hi apart from the cross terms), added in fp32
    auto accumulate = [&](const uint8_t* rows, const uint8_t* rows_lo,
                          uint32_t bh, uint32_t bl) {
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        uint32_t ah[BQ / 8][4], al[BQ / 8][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t off = a_off[i] + m * 2 * BQ * 128 + kk * 1024;
            ah[kk][i] = *reinterpret_cast<const uint32_t*>(rows + off);
            al[kk][i] = *reinterpret_cast<const uint32_t*>(rows_lo + off);
          }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float big[16], small[16];
          fence_regs(ah);
          fence_regs(al);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 8; ++kk) {
            const uint32_t off = c * 32 * 128 + kk * 32;
            const uint64_t dh = sw128_desc(bh + off, 16, 1024);
            tf32x3::wgmma_rs32(big, ah[kk], dh, kk > 0);
            tf32x3::wgmma_rs32(small, al[kk], dh, kk > 0);
            tf32x3::wgmma_rs32(small, ah[kk], sw128_desc(bl + off, 16, 1024),
                               1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(big);
          fence_regs(small);
          fence_regs(ah);
          fence_regs(al);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[m][c][i] += big[i] + small[i];
        }
      }
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    };
    // (m, element) of the exchange tiles this thread writes or reads: the
    // m64n32 accumulator's rows kv 16 warp + g (+ 8), columns q
    auto xoff = [&](int nt, int hf) {
      return tf32x3::sw128_f32(warp * 16 + g + 8 * hf, nt * 8 + c4 * 2);
    };

    bool any = false;  // a tile processed: the exchange barriers are primed
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_ready + 8 * s, (j / kStages) & 1);
      const int q0 = (first + j % per_head) * BQ;
      const int q_mn = sInfo[2 * s], q_mx = sInfo[2 * s + 1];
      if ((q_mn == 0 && q_mx == 0) ||
          (causal && q_offset + q0 + BQ - 1 < k0)) {  // nothing to see
        release(s);
        continue;
      }
      uint8_t* st = smem + L::kRing + s * L::kStage;
      const uint32_t sts = sbase + L::kRing + s * L::kStage;
      float sc[16], sx[16];  // S^T (or dP^T): the hi-hi chain, cross terms
      fence_regs(sc);
      fence_regs(sx);
      wgmma_fence();
      // S^T against Q (warpgroup 1) or dP^T against dO (warpgroup 2): one
      // call with the operands selected, not two branches (wgmma in a
      // divergent path is serialized)
      issue_scores<D>(sc, sx, own, own_lo, sts + (cw == 0 ? L::kQ : L::kDO),
                      sts + (cw == 0 ? L::kQlo : L::kDOlo));
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(sx);
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] += sx[i];
      if (cw == 0) {
        // P^T = where(mask, exp2(S^T scale log2(e) - LSE log2(e)), 0): rows
        // kv, columns q (the bf16 kernel's, at 32 columns)
        const float* lse2 = sLse + s * BQ;
        const bool interior = !mask_all && q_mn != 0 && q_mn == q_mx &&
                              k_mn == q_mn && k_mx == q_mn &&
                              (!causal || q_offset + q0 >= warp_last);
        if (interior) {
#pragma unroll
          for (int nt = 0; nt < BQ / 8; ++nt) {
            const float2 l =
                *reinterpret_cast<const float2*>(lse2 + nt * 8 + c4 * 2);
            sc[nt * 4 + 0] = exp2f(fmaf(sc[nt * 4 + 0], scale_log2, -l.x));
            sc[nt * 4 + 1] = exp2f(fmaf(sc[nt * 4 + 1], scale_log2, -l.y));
            sc[nt * 4 + 2] = exp2f(fmaf(sc[nt * 4 + 2], scale_log2, -l.x));
            sc[nt * 4 + 3] = exp2f(fmaf(sc[nt * 4 + 3], scale_log2, -l.y));
          }
        } else {
          const int* qs = sSeg + s * BQ;
#pragma unroll
          for (int nt = 0; nt < BQ / 8; ++nt) {
            const int col = nt * 8 + c4 * 2;
            const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
            const int2 qseg = *reinterpret_cast<const int2*>(qs + col);
            const int qpos = q_offset + q0 + col;
            const bool ok00 = kseg0 != 0 && qseg.x == kseg0 &&
                              (!causal || qpos >= r0);
            const bool ok01 = kseg0 != 0 && qseg.y == kseg0 &&
                              (!causal || qpos + 1 >= r0);
            const bool ok10 = kseg1 != 0 && qseg.x == kseg1 &&
                              (!causal || qpos >= r1);
            const bool ok11 = kseg1 != 0 && qseg.y == kseg1 &&
                              (!causal || qpos + 1 >= r1);
            const float p00 = exp2f(fmaf(sc[nt * 4 + 0], scale_log2, -l.x));
            const float p01 = exp2f(fmaf(sc[nt * 4 + 1], scale_log2, -l.y));
            const float p10 = exp2f(fmaf(sc[nt * 4 + 2], scale_log2, -l.x));
            const float p11 = exp2f(fmaf(sc[nt * 4 + 3], scale_log2, -l.y));
            sc[nt * 4 + 0] = ok00 ? p00 : 0.f;
            sc[nt * 4 + 1] = ok01 ? p01 : 0.f;
            sc[nt * 4 + 2] = ok10 ? p10 : 0.f;
            sc[nt * 4 + 3] = ok11 ? p11 : 0.f;
          }
        }
        if (any) bar_sync(kBarPFree, 256);  // dV of the last tile is done
        // P^T, split, for warpgroup 2's dV
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t h0, l0, h1, l1;
            tf32x3::split(sc[nt * 4 + 2 * hf], h0, l0);
            tf32x3::split(sc[nt * 4 + 2 * hf + 1], h1, l1);
            *reinterpret_cast<uint2*>(x + L::kPhi + xoff(nt, hf)) =
                make_uint2(h0, h1);
            *reinterpret_cast<uint2*>(x + L::kPlo + xoff(nt, hf)) =
                make_uint2(l0, l1);
          }
        fence_proxy_async();
        bar_arrive(kBarPFull, 256);
        bar_sync(kBarDPFull, 256);  // dP^T in the dS^T lo tile
        // dS^T = P^T (dP^T - Di) scale, split, over dP^T (each thread reads
        // the elements it then writes)
        const float* dis = sDi + s * BQ;
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 d = *reinterpret_cast<const float2*>(dis + nt * 8 +
                                                              c4 * 2);
            const float2 dp =
                *reinterpret_cast<const float2*>(x + L::kSlo + xoff(nt, hf));
            const float s0 = sc[nt * 4 + 2 * hf] * (dp.x - d.x) * sm_scale;
            const float s1 = sc[nt * 4 + 2 * hf + 1] * (dp.y - d.y) * sm_scale;
            uint32_t h0, l0, h1, l1;
            tf32x3::split(s0, h0, l0);
            tf32x3::split(s1, h1, l1);
            *reinterpret_cast<uint2*>(x + L::kShi + xoff(nt, hf)) =
                make_uint2(h0, h1);
            *reinterpret_cast<uint2*>(x + L::kSlo + xoff(nt, hf)) =
                make_uint2(l0, l1);
          }
        fence_proxy_async();
        bar_sync(1, 128);  // dS^T whole for this warpgroup's products
        accumulate(st + L::kQ, st + L::kQlo, xs + L::kShi, xs + L::kSlo);
        bar_arrive(kBarDPFree, 256);  // the dS^T tiles may take dP^T again
      } else {
        if (any) bar_sync(kBarDPFree, 256);  // dK of the last tile is done
        // dP^T, whole, for warpgroup 1
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(x + L::kSlo + xoff(nt, hf)) =
                make_float2(sc[nt * 4 + 2 * hf], sc[nt * 4 + 2 * hf + 1]);
        bar_arrive(kBarDPFull, 256);
        bar_sync(kBarPFull, 256);  // P^T ready
        accumulate(st + L::kDO, st + L::kDOlo, xs + L::kPhi, xs + L::kPlo);
        bar_arrive(kBarPFree, 256);
      }
      release(s);
      any = true;
    }
    // the last tile's free barrier, so that every arrival is matched
    if (any) bar_sync(cw == 0 ? kBarPFree : kBarDPFree, 256);

    // dK (warpgroup 1) or dV: element (e of chunk c, d block m) of acc is
    // d row 64 m + 16 warp + g (+ 8), kv row k0 + 32 c + 8 (e / 4) + 2 c4
    // (+ 1)
    float* outp = cw == 0 ? dk_out : dv_out;
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int d = 64 * m + warp * 16 + g + (i & 2 ? 8 : 0);
          const int r = k0 + c * 32 + (i / 4) * 8 + c4 * 2 + (i & 1);
          if (r < S)
            outp[(((long)b * S + r) * Hkv + hk) * D + d] = acc[m][c][i];
        }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *di, *q_seg, *kv_seg;
  int B, H, Hkv, Lq, S;
  float sm_scale;
  int causal, q_offset, mask_all, dtype;
  cudaStream_t stream;
};

constexpr CUtensorMapSwizzle kSw128 = CU_TENSOR_MAP_SWIZZLE_128B;

// A [B][L][heads * D] tensor map of T with a [64 columns] x [rows] box.
template <typename T>
bool map_rows(CUtensorMap* map, const void* base, int B, int L, int heads,
              int D, int rows) {
  return make_map_3d(map, tma_type<T>(), 2, base, (uint64_t)heads * D, L, B,
                     kBox, rows, kSw128);
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!map_rows<T>(&tq, a.q, a.B, a.Lq, a.H, D, 64) ||
      !map_rows<T>(&tdo, a.dout, a.B, a.Lq, a.H, D, 64) ||
      !map_rows<T>(&tdq, dq, a.B, a.Lq, a.H, D, 64) ||
      !map_rows<T>(&tk, a.k, a.B, a.S, a.Hkv, D, kBlockN) ||
      !map_rows<T>(&tv, a.v, a.B, a.S, a.Hkv, D, kBlockN))
    return cudaErrorNotSupported;
  constexpr int smem = SmemDq<D>::kAlloc;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int n_qtiles = (a.Lq + kRows - 1) / kRows;
  dim3 grid(a.H, a.B, n_qtiles);
  fa_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<uint16_t*>(dq),
      static_cast<const float*>(a.lse),
      static_cast<const float*>(a.di), static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), a.H, a.Hkv, a.Lq, a.S, a.sm_scale,
      a.sm_scale * kLog2e, a.causal, a.q_offset, n_qtiles, a.mask_all);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!map_rows<T>(&tq, a.q, a.B, a.Lq, a.H, D, kBlockQ) ||
      !map_rows<T>(&tdo, a.dout, a.B, a.Lq, a.H, D, kBlockQ) ||
      !map_rows<T>(&tk, a.k, a.B, a.S, a.Hkv, D, 64) ||
      !map_rows<T>(&tv, a.v, a.B, a.S, a.Hkv, D, 64) ||
      !map_rows<T>(&tdk, dk, a.B, a.S, a.Hkv, D, 64) ||
      !map_rows<T>(&tdv, dv, a.B, a.S, a.Hkv, D, 64))
    return cudaErrorNotSupported;
  constexpr int smem = SmemDkv<D>::kAlloc;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  dim3 grid(a.Hkv, a.B, (a.S + kRows - 1) / kRows);
  fa_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, tdk, tdv, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.di), static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), a.H, a.Hkv, a.Lq, a.S, a.sm_scale,
      a.sm_scale * kLog2e, a.causal, a.q_offset, a.mask_all);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  constexpr int smem = SmemF32<D>::kBytes;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int n_qtiles = (a.Lq + kRowsF32 - 1) / kRowsF32;
  dim3 grid(a.H, a.B, n_qtiles);
  fa_bwd_dq_f32_kernel<D><<<grid, kThreadsF32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<const int*>(a.q_seg), static_cast<const int*>(a.kv_seg),
      static_cast<float*>(dq), a.H, a.Hkv, a.Lq, a.S, a.sm_scale,
      a.sm_scale * kLog2e, a.causal, a.q_offset, n_qtiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  CUtensorMap tq, tk, tv, tdo;
  auto map = [&](CUtensorMap* m, const void* base, int L, int heads,
                 int rows) {
    return make_map_3d(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base,
                       (uint64_t)heads * D, L, a.B, 32, rows, kSw128);
  };
  if (!map(&tq, a.q, a.Lq, a.H, kTileQF32) ||
      !map(&tdo, a.dout, a.Lq, a.H, kTileQF32) ||
      !map(&tk, a.k, a.S, a.Hkv, kRowsDkvF32) ||
      !map(&tv, a.v, a.S, a.Hkv, kRowsDkvF32))
    return cudaErrorNotSupported;
  constexpr int smem = SmemDkvF32<D>::kAlloc;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkv_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  dim3 grid(a.Hkv, a.B, (a.S + kRowsDkvF32 - 1) / kRowsDkvF32);
  fa_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<const int*>(a.q_seg), static_cast<const int*>(a.kv_seg),
      a.H, a.Hkv, a.Lq, a.S, a.sm_scale, a.sm_scale * kLog2e, a.causal,
      a.q_offset, a.mask_all);
  return cudaGetLastError();
}

bool valid(int B, int H, int Hkv, int Lq, int S, int q_offset) {
  return B > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && Lq > 0 && S > 0 &&
         B <= 65535 && q_offset >= 0 && (Lq + kRows - 1) / kRows <= 65535 &&
         (S + kRows - 1) / kRows <= 65535;
}

int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* di, const void* q_seg,
             const void* kv_seg, void* dq, int B, int H, int Hkv, int Lq,
             int S, int D, float sm_scale, int causal, int q_offset,
             int mask_all, int dtype, void* stream) {
  if (!valid(B, H, Hkv, Lq, S, q_offset) || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, di, q_seg, kv_seg, B, H, Hkv, Lq, S,
               sm_scale, causal, q_offset, mask_all, dtype,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kBfloat16:
      return D == 128 ? launch_dq<__nv_bfloat16, 128>(a, dq)
                      : launch_dq<__nv_bfloat16, 64>(a, dq);
    case kFloat16:
      return D == 128 ? launch_dq<__half, 128>(a, dq)
                      : launch_dq<__half, 64>(a, dq);
    case kFloat32:
      return D == 128 ? launch_dq_f32<128>(a, dq) : launch_dq_f32<64>(a, dq);
    default:
      return cudaErrorInvalidValue;
  }
}

int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, const void* q_seg,
              const void* kv_seg, void* dk, void* dv, int B, int H, int Hkv,
              int Lq, int S, int D, float sm_scale, int causal, int q_offset,
              int mask_all, int dtype, void* stream) {
  if (!valid(B, H, Hkv, Lq, S, q_offset) || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, di, q_seg, kv_seg, B, H, Hkv, Lq, S,
               sm_scale, causal, q_offset, mask_all, dtype,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kBfloat16:
      return D == 128 ? launch_dkv<__nv_bfloat16, 128>(a, dk, dv)
                      : launch_dkv<__nv_bfloat16, 64>(a, dk, dv);
    case kFloat16:
      return D == 128 ? launch_dkv<__half, 128>(a, dk, dv)
                      : launch_dkv<__half, 64>(a, dk, dv);
    case kFloat32:
      return D == 128 ? launch_dkv_f32<128>(a, dk, dv)
                      : launch_dkv_f32<64>(a, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mc_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* q_seg, const void* kv_seg,
    void* dq, int B, int H, int Hkv, int Lq, int S, int D, float sm_scale,
    int causal, int q_offset, int dtype, void* stream) {
  return dq_entry(q, k, v, dout, lse, di, q_seg, kv_seg, dq, B, H, Hkv, Lq,
                  S, D, sm_scale, causal, q_offset, 0, dtype, stream);
}

extern "C" int mc_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* q_seg, const void* kv_seg,
    void* dk, void* dv, int B, int H, int Hkv, int Lq, int S, int D,
    float sm_scale, int causal, int q_offset, int dtype, void* stream) {
  return dkv_entry(q, k, v, dout, lse, di, q_seg, kv_seg, dk, dv, B, H, Hkv,
                   Lq, S, D, sm_scale, causal, q_offset, 0, dtype, stream);
}

// The same with every tile through the per-element mask: the fast-path
// test holds the two bit-equal.
extern "C" int mc_flash_attention_bwd_dq_mask_all(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* q_seg, const void* kv_seg,
    void* dq, int B, int H, int Hkv, int Lq, int S, int D, float sm_scale,
    int causal, int q_offset, int dtype, void* stream) {
  return dq_entry(q, k, v, dout, lse, di, q_seg, kv_seg, dq, B, H, Hkv, Lq,
                  S, D, sm_scale, causal, q_offset, 1, dtype, stream);
}

extern "C" int mc_flash_attention_bwd_dkv_mask_all(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* q_seg, const void* kv_seg,
    void* dk, void* dv, int B, int H, int Hkv, int Lq, int S, int D,
    float sm_scale, int causal, int q_offset, int dtype, void* stream) {
  return dkv_entry(q, k, v, dout, lse, di, q_seg, kv_seg, dk, dv, B, H, Hkv,
                   Lq, S, D, sm_scale, causal, q_offset, 1, dtype, stream);
}

// Dynamic shared memory of one block (bytes) of K3 (dkv = 0) or K4 at
// `dtype`, for the build report.
extern "C" int mc_flash_attention_bwd_smem(int dkv, int D, int dtype) {
  if (dtype == kFloat32 && dkv)
    return D == 128 ? SmemDkvF32<128>::kAlloc : SmemDkvF32<64>::kAlloc;
  if (dtype == kFloat32)
    return D == 128 ? SmemF32<128>::kBytes : SmemF32<64>::kBytes;
  if (dkv) return D == 128 ? SmemDkv<128>::kAlloc : SmemDkv<64>::kAlloc;
  return D == 128 ? SmemDq<128>::kAlloc : SmemDq<64>::kAlloc;
}
