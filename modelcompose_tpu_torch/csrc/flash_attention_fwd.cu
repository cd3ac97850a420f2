// Flash-attention forward (kernel K1) for Hopper, sm_90a: TMA loads and
// wgmma, one producer warp and two consumer warpgroups per block.
//
// Replaces the Pallas TPU kernel modelcompose_tpu/ops/flash_attention.py
// `_fa_kernel` (driven by `_flash_attention_forward`):
//     O = softmax(Q K^T * scale + mask) V   and   LSE = m + log(l)
// with the mask = same segment, kv segment != 0, and (causal)
// q_offset + i >= j.  Padding rows (segment 0) come out as the mean of V,
// as on the TPU; callers ignore them.
//
// What bounds it on the H100: tensor-core FLOPs.  At the MCUB-4 prefill
// bucket (Lq = S = 3,328, 32 heads, D = 128) it does about 88 GFLOP of
// causal work over 108 MB of q/k/v/o, far above the ~295 flop/byte ridge,
// so the only road to the card's rate is wgmma fed by TMA.  The design:
//   - one block per (128-row q tile, head, batch row), 384 threads: warp 0
//     is the producer (setmaxnreg 40) and issues every load; warpgroups 1
//     and 2 are consumers (setmaxnreg 232) and own 64 q rows each;
//   - TMA tensor maps over the public layouts as 3-D [B][L][heads * D]
//     with 64-column boxes and the 128-byte swizzle: a box never crosses
//     into the next batch row, and rows past L arrive as zeros;
//   - Q is loaded once; K and V pass through a ring of three stages with
//     full/empty mbarriers, so the next tiles' loads overlap this tile's
//     math (232,016 bytes of shared memory at D = 128);
//   - S = Q K^T is wgmma m64nBNk16 with both operands in shared memory
//     (K-major); the online softmax runs in fp32 with exp2f and the scale
//     pre-multiplied by log2(e); P is cast to T in registers (the JAX
//     kernel's _gemm2_cast) and is the register A operand of wgmma
//     m64nDk16 with V as the transposed (MN-major) B operand;
//   - within a warpgroup the kv loop is pipelined: S of tile j and P.V of
//     tile j-1 are issued together, and tile j's softmax runs while the
//     tensor cores do that P.V;
//   - the producer also stages each kv tile's segment ids and their min
//     and max: a warp whose 16 q rows all share that one nonzero segment,
//     with the tile wholly below its diagonal, skips the per-element mask;
//   - kv tiles wholly in the future of a warpgroup's rows are skipped; q
//     tiles run heaviest first (the q tile index is the slowest grid axis,
//     reversed), so the causal tail is made of light blocks.
//
// The element type T is bf16 or fp16 (the model's dtype; the JAX kernel
// takes its operands in their own dtype): the products are wgmma's
// .bf16 or .f16 forms, P is rounded to T (for fp16 with its subnormals
// kept, as the JAX cast keeps them) and O is stored in T; the softmax,
// the LSE and the accumulators are fp32 either way.  fp16's narrower
// exponent touches only P (in [0, 1], so below 6.1e-5 it is subnormal,
// never out of range) and O (a convex mix of V's rows).
//
// At fp32 (a float32 model, `--bf16 False` training) a kernel of its own,
// fa_fwd_f32_kernel below, computes the same function with both products
// in 3xTF32 and P kept fp32; the C entries pick it by the dtype code.
//
// Layouts (the JAX package's public layout, no padding, no lifted
// segment ids): q [B, Lq, H, D], k/v [B, S, Hkv, D], all of type T (bf16,
// fp16 or fp32) and contiguous; segment ids int32 [B, Lq] / [B, S]; out
// [B, Lq, H, D] T; lse [B, H, Lq] fp32.  GQA: kv head = h / (H / Hkv).
// D in {64, 128}.

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

constexpr int kBlockM = 128;   // q rows per block: two warpgroups of 64
constexpr int kStages = 3;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBox = 64;       // 2-byte columns per TMA box: the 128-byte swizzle span
// kv rows per tile: 128 beat 64 on the H100 (PERF.md), timed by
// scripts/torch_kernel_ab.py from a copy of this file with 64 here.
constexpr int kBlockN = 128;
static_assert(kBlockN == 64 || kBlockN == 128, "kv tile of 64 or 128 rows");
constexpr float kNegInf = -1e30f;    // the JAX kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one block, in bytes from a 1024-aligned base.  Q is
// [2 halves][D/64 boxes][64 rows][128 B]; each K or V stage is
// [D/64 boxes][BN rows][128 B].
template <int D>
struct Smem {
  static constexpr int BN = kBlockN;
  static constexpr int kBoxes = D / kBox;
  static constexpr int kQ = 0;
  static constexpr int kKVBytes = BN * D * 2;
  static constexpr int kK = kQ + kBlockM * D * 2;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kSeg = kV + kStages * kKVBytes;  // int [kStages][BN]
  static constexpr int kInfo = kSeg + kStages * BN * 4;  // int [kStages][2]
  static constexpr int kBar = kInfo + kStages * 2 * 4;   // q, full[], empty[]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
              T* __restrict__ out, float* __restrict__ lse,
              int H, int Hkv, int Lq, int S, float scale_log2, int causal,
              int q_offset, int n_qtiles, int mask_all) {
  using L = Smem<D>;
  constexpr int BN = kBlockN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  int* sSeg = reinterpret_cast<int*>(smem + L::kSeg);
  int* sInfo = reinterpret_cast<int*>(smem + L::kInfo);
  const uint32_t bar_q = sbase + L::kBar;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_q + 8 * (1 + kStages);  // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kBlockM;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;

  int n_tiles = (S + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q_offset + q0 + kBlockM - 1) / BN + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // every producer lane arrives
      mbar_init(bar_empty + 8 * s, 8);  // every consumer warp arrives
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<40>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        prefetch_tensormap(&tq);
        prefetch_tensormap(&tk);
        prefetch_tensormap(&tv);
        mbar_arrive_expect_tx(bar_q, kBlockM * D * 2);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load_3d(sbase + L::kQ + (half * L::kBoxes + c) * 64 * 128,
                        &tq, bar_q, h * D + c * kBox, q0 + half * 64, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
        const int k0 = j * BN;
        int mn = INT_MAX, mx = INT_MIN;
        for (int i = lane; i < BN; i += 32) {
          const int seg = k0 + i < S ? kv_seg[(long)b * S + k0 + i] : 0;
          sSeg[s * BN + i] = seg;
          mn = min(mn, seg);
          mx = max(mx, seg);
        }
        mn = warp_min(mn);
        mx = warp_max(mx);
        if (lane == 0) {
          sInfo[2 * s] = mn;
          sInfo[2 * s + 1] = mx;
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
    reg_alloc<232>();
    const int cw = tid / 128 - 1;  // which 64 rows of the q tile
    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4;   // accumulator row within the warp's 8
    const int c4 = lane % 4;  // accumulator column pair
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    const int seg0 = r0 < Lq ? q_seg[(long)b * Lq + r0] : 0;
    const int seg1 = r1 < Lq ? q_seg[(long)b * Lq + r1] : 0;
    const int q_mn = warp_min(min(seg0, seg1));
    const int q_mx = warp_max(max(seg0, seg1));
    const int pos0 = q_offset + r0, pos1 = q_offset + r1;
    const int warp_pos = q_offset + q0 + cw * 64 + warp * 16;  // its first row
    int n_mine = n_tiles;  // kv tiles these 64 rows read
    if (causal) n_mine = min(n_tiles, (q_offset + q0 + cw * 64 + 63) / BN + 1);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[BN / 2];       // S of the current tile, then its P in fp32
    uint32_t pa[BN / 16][4];  // P in T: the A fragments of P.V
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const uint32_t q_tile = sbase + L::kQ + cw * L::kBoxes * 64 * 128;

    // S = Q K^T of the tile in stage s, 64 x BN per warpgroup, 16 columns
    // of D per step (issued, not waited for).
    auto issue_qk = [&](int s) {
      const uint32_t k_tile = sbase + L::kK + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;  // box, 32-byte step inside it
        wgmma_ss<T, BN>(sc, sw128_desc(q_tile + c * 64 * 128 + w * 32, 16, 1024),
                     sw128_desc(k_tile + c * BN * 128 + w * 32, 16, 1024),
                     kk > 0);
      }
    };
    // O += P V of the tile in stage s: the S accumulator of columns
    // 16kk..16kk+15 is the A fragment of the kk-th 16-deep step.
    auto issue_pv = [&](int s) {
      const uint32_t v_tile = sbase + L::kV + s * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb<T, D>(o, pa[kk],
                       sw128_desc(v_tile + kk * 16 * 128, BN * 128, 1024));
    };
    // Scale (log2 units), mask where the tile needs it, online softmax:
    // sc becomes P, (m, l) move on, and (a0, a1) rescale O.
    auto softmax = [&](int j, int s, float& a0, float& a1) {
      const int k0 = j * BN;
      const int k_mn = sInfo[2 * s], k_mx = sInfo[2 * s + 1];
      const bool interior = !mask_all && k_mn != 0 && k_mn == k_mx &&
                            q_mn == k_mn && q_mx == k_mn &&
                            (!causal || k0 + BN - 1 <= warp_pos);
      float mx0 = kNegInf, mx1 = kNegInf;
      if (interior) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[nt * 4 + e] *= scale_log2;
            sc[nt * 4 + 2 + e] *= scale_log2;
            mx0 = fmaxf(mx0, sc[nt * 4 + e]);
            mx1 = fmaxf(mx1, sc[nt * 4 + 2 + e]);
          }
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
            sc[nt * 4 + e] = ok0 ? sc[nt * 4 + e] * scale_log2 : kNegInf;
            sc[nt * 4 + 2 + e] = ok1 ? sc[nt * 4 + 2 + e] * scale_log2 : kNegInf;
            mx0 = fmaxf(mx0, sc[nt * 4 + e]);
            mx1 = fmaxf(mx1, sc[nt * 4 + 2 + e]);
          }
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = exp2f(m0 - mn0);
      a1 = exp2f(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        sc[nt * 4 + 0] = exp2f(sc[nt * 4 + 0] - mn0);
        sc[nt * 4 + 1] = exp2f(sc[nt * 4 + 1] - mn0);
        sc[nt * 4 + 2] = exp2f(sc[nt * 4 + 2] - mn1);
        sc[nt * 4 + 3] = exp2f(sc[nt * 4 + 3] - mn1);
        rs0 += sc[nt * 4 + 0] + sc[nt * 4 + 1];
        rs1 += sc[nt * 4 + 2] + sc[nt * 4 + 3];
      }
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      m0 = mn0;
      m1 = mn1;
    };
    // O to the new max, and P to T (the JAX kernel's _gemm2_cast).
    auto rescale_and_pack = [&](float a0, float a1) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt * 4 + 0] *= a0;
        o[dt * 4 + 1] *= a0;
        o[dt * 4 + 2] *= a1;
        o[dt * 4 + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack2<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    };

    // Pipelined over the kv tiles: S of tile j and P.V of tile j-1 are
    // issued together, and the softmax of tile j runs while the tensor
    // cores do P.V.  A tile's stage is released once its P.V is done.
    mbar_wait(bar_q, 0);
    float a0, a1;
    mbar_wait(bar_full, 0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, 0, a0, a1);
    rescale_and_pack(a0, a1);
    for (int j = 1; j < n_mine; ++j) {
      const int s = j % kStages, s_prev = (j - 1) % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      fence_regs(o);
      fence_regs(pa);
      fence_regs(sc);
      wgmma_fence();
      issue_qk(s);
      wgmma_commit();
      issue_pv(s_prev);
      wgmma_commit();
      fence_regs(o);
      fence_regs(pa);
      wgmma_wait<1>();  // S of tile j
      fence_regs(sc);
      softmax(j, s, a0, a1);
      wgmma_wait<0>();  // P.V of tile j-1
      fence_regs(o);
      fence_regs(pa);
      release(s_prev);
      rescale_and_pack(a0, a1);
    }
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv((n_mine - 1) % kStages);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release((n_mine - 1) % kStages);
    // kv tiles wholly in the future of these 64 rows: released unread
    for (int j = n_mine; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      release(s);
    }

    const float sl0 = l0 == 0.f ? 1.f : l0;
    const float sl1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / sl0, inv1 = 1.f / sl1;
    const long q_stride = (long)H * D;
    T* ob = out + (long)b * Lq * q_stride + (long)h * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + c4 * 2;
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
            pack2<T>(o[dt * 4 + 0] * inv0, o[dt * 4 + 1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
            pack2<T>(o[dt * 4 + 2] * inv1, o[dt * 4 + 3] * inv1);
    }
    if (c4 == 0) {
      // back to natural log; a row with no valid key keeps the -1e30 floor
      float* lb = lse + ((long)b * H + h) * Lq;
      if (r0 < Lq)
        lb[r0] = (m0 == kNegInf ? kNegInf : m0 * kLn2) + logf(sl0);
      if (r1 < Lq)
        lb[r1] = (m1 == kNegInf ? kNegInf : m1 * kLn2) + logf(sl1);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_seg, const void* kv_seg, void* out,
                   void* lse, int B, int H, int Hkv, int Lq, int S,
                   float sm_scale, int causal, int q_offset, int mask_all,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const auto type = tma_type<T>();
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map_3d(&tq, type, 2, q, (uint64_t)H * D, Lq, B, kBox, 64, sw) ||
      !make_map_3d(&tk, type, 2, k, (uint64_t)Hkv * D, S, B, kBox, kBlockN,
                   sw) ||
      !make_map_3d(&tv, type, 2, v, (uint64_t)Hkv * D, S, B, kBox, kBlockN,
                   sw))
    return cudaErrorNotSupported;
  constexpr int smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (Lq + kBlockM - 1) / kBlockM;
  dim3 grid(H, B, n_qtiles);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<T*>(out),
      static_cast<float*>(lse), H, Hkv, Lq, S, sm_scale * kLog2e, causal,
      q_offset, n_qtiles, mask_all);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- fp32
// The fp32 kernel: the same function at fp32 operands, as the JAX kernel
// computes it (its dots at fp32 with fp32 accumulation, and _gemm2_cast the
// identity, so P stays fp32 for P.V).  Both products are 3xTF32 on wgmma
// (csrc/tf32x3.cuh: each operand split once into tf32 hi and lo, the
// hi-hi chain and the cross terms in accumulators of their own).  Bounded
// by operations: three tf32 products for each fp32 one.  The design:
//   - one block per (128-row q tile, head, batch row), 384 threads: warp 0
//     issues every TMA load; warps 1-3 (the converters) split each kv tile
//     once it lands (warp 0 splitting too, after its loads, was 6% slower:
//     the next load waited on its share); warpgroups 1 and 2 (setmaxnreg
//     232) own 64 q rows each;
//   - TMA maps as the bf16 kernel's, with 32-column (128-byte) boxes: Q
//     once, K and V through a two-stage ring of 32-row tiles (barriers:
//     full, landed; ready, split; empty, read by the products);
//   - the converters split K in place (hi over the landed words, lo into a
//     tile beside it) and write V transposed, hi and lo, with each 8-row
//     block in the permuted k order, as the K-major B operand of P.V;
//   - each consumer warpgroup splits its own 64 Q rows once: hi in place
//     (the shared-memory A operand), lo into registers (the register A
//     operand of Q_lo K_hi);
//   - S = Q_hi K_hi (from zero) and Q_lo K_hi + Q_hi K_lo (an accumulator
//     of its own) are m64n32k8 wgmma; the online softmax is the bf16
//     kernel's, with the mask skipped on interior tiles; P, split, is the
//     register A operand of P.V against V^T hi and lo, 32 columns of D at
//     a time, each tile's product added to O in fp32;
//   - shared memory is the limit: Q (64 KB at D = 128) and two stages of
//     K, K lo, raw V, V^T hi and V^T lo (80 KB each) fill 224 KB, so kv
//     tiles are 32 rows and Q's lo lives in registers.
constexpr int kRowsF32 = 128;   // q rows per block: two warpgroups of 64
constexpr int kColsF32 = 32;    // kv rows per tile
constexpr int kStagesF32 = 2;   // K/V ring depth
constexpr int kConverters = 96;  // warps 1-3 split the kv tiles
constexpr int kBoxF32 = 32;     // fp32 columns per TMA box: 128 bytes

// Shared memory of the fp32 block, in bytes from a 1024-aligned base.  Q
// is [2 halves][D/32 boxes][64 rows][128 B] (hi once split); a stage holds
// K (split in place), K lo and the raw V as [D/32 boxes][32 rows][128 B],
// and V^T hi and lo as [D rows][128 B].
template <int D>
struct SmemF32 {
  static constexpr int BN = kColsF32;
  static constexpr int kBoxes = D / kBoxF32;
  static constexpr int kTile = BN * D * 4;  // one 32-row tile, any layout
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kRowsF32 * D * 4;
  static constexpr int kK = 0, kKlo = kTile, kV = 2 * kTile, kVhi = 3 * kTile,
                       kVlo = 4 * kTile;  // within a stage
  static constexpr int kStage = 5 * kTile;
  static constexpr int kSeg = kRing + kStagesF32 * kStage;  // int [stages][BN]
  static constexpr int kInfo = kSeg + kStagesF32 * BN * 4;  // int [stages][2]
  // q, full[stages] (landed), ready[stages] (split), empty[stages] (read)
  static constexpr int kBar = kInfo + kStagesF32 * 2 * 4;
  static constexpr int kBytes = kBar + (1 + 3 * kStagesF32) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};
static_assert(SmemF32<128>::kAlloc <= 232448, "one fp32 block fits an SM");
static_assert(kColsF32 == 32 && kConverters % 32 == 0,
              "transpose_split_tile: 32 rows, a row a lane");

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const int* __restrict__ q_seg,
                  const int* __restrict__ kv_seg, float* __restrict__ out,
                  float* __restrict__ lse, int H, int Hkv, int Lq, int S,
                  float scale_log2, int causal, int q_offset, int n_qtiles,
                  int mask_all) {
  using L = SmemF32<D>;
  constexpr int BN = kColsF32;
  constexpr int kStages = kStagesF32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);
  int* sSeg = reinterpret_cast<int*>(smem + L::kSeg);
  int* sInfo = reinterpret_cast<int*>(smem + L::kInfo);
  const uint32_t bar_q = sbase + L::kBar;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_ready = bar_full + 8 * kStages;   // + 8 * stage
  const uint32_t bar_empty = bar_ready + 8 * kStages;  // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kRowsF32;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;

  int n_tiles = (S + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q_offset + q0 + kRowsF32 - 1) / BN + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);            // every producer lane
      mbar_init(bar_ready + 8 * s, kConverters);  // every converter thread
      mbar_init(bar_empty + 8 * s, 8);            // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    reg_dealloc<40>();
    if (tid < 32) {
      // ------------------------------------------------------ producer
      const int lane = tid;
      if (lane == 0) {
        prefetch_tensormap(&tq);
        prefetch_tensormap(&tk);
        prefetch_tensormap(&tv);
        mbar_arrive_expect_tx(bar_q, kRowsF32 * D * 4);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load_3d(sbase + L::kQ + (half * L::kBoxes + c) * 64 * 128,
                        &tq, bar_q, h * D + c * kBoxF32, q0 + half * 64, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t st = sbase + L::kRing + s * L::kStage;
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
        const int k0 = j * BN;
        const int seg = k0 + lane < S ? kv_seg[(long)b * S + k0 + lane] : 0;
        sSeg[s * BN + lane] = seg;
        const int mn = warp_min(seg), mx = warp_max(seg);
        if (lane == 0) {
          sInfo[2 * s] = mn;
          sInfo[2 * s + 1] = mx;
          mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kTile);
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load_3d(st + L::kK + c * BN * 128, &tk, bar_full + 8 * s,
                        hk * D + c * kBoxF32, k0, b);
            tma_load_3d(st + L::kV + c * BN * 128, &tv, bar_full + 8 * s,
                        hk * D + c * kBoxF32, k0, b);
          }
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
    } else {
      // ---------------------------------------------------- converters
      // K split in place (hi over x, lo beside it); V transposed into
      // V^T hi and lo; then the stage is ready for the products.
      const int ct = tid - 32;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        uint8_t* st = smem + L::kRing + s * L::kStage;
        mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
        tf32x3::split_tile<BN, D>(st + L::kK, st + L::kKlo, ct, kConverters);
        tf32x3::transpose_split_tile<D>(st + L::kV, st + L::kVhi,
                                        st + L::kVlo, ct, kConverters);
        fence_proxy_async();  // the generic writes, before wgmma reads them
        mbar_arrive(bar_ready + 8 * s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int cw = tid / 128 - 1;  // which 64 rows of the q tile
    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4;   // accumulator row within the warp's 8
    const int c4 = lane % 4;  // accumulator column pair
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    const int seg0 = r0 < Lq ? q_seg[(long)b * Lq + r0] : 0;
    const int seg1 = r1 < Lq ? q_seg[(long)b * Lq + r1] : 0;
    const int q_mn = warp_min(min(seg0, seg1));
    const int q_mx = warp_max(max(seg0, seg1));
    const int pos0 = q_offset + r0, pos1 = q_offset + r1;
    const int warp_pos = q_offset + q0 + cw * 64 + warp * 16;  // its first row
    int n_mine = n_tiles;  // kv tiles these 64 rows read
    if (causal) n_mine = min(n_tiles, (q_offset + q0 + cw * 64 + 63) / BN + 1);
    const uint32_t q_tile = sbase + L::kQ + cw * L::kBoxes * 64 * 128;

    // Q, once: hi in place, lo as the register A operand of Q_lo K_hi
    mbar_wait(bar_q, 0);
    uint32_t qlo[D / 8][4];
    tf32x3::split_rows<D>(smem + L::kQ + cw * L::kBoxes * 64 * 128, qlo, warp,
                          g, c4);
    fence_proxy_async();
    bar_sync(1 + cw, 128);  // the warpgroup's Q hi in place for wgmma

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[BN / 2];  // S: the hi-hi chain, then S, then P
    float sx[BN / 2];  // S: the cross terms
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // Scale (log2 units), mask where the tile needs it, online softmax:
    // sc becomes P, (m, l) move on, and (a0, a1) rescale O.  The bf16
    // kernel's, at 32 columns.
    auto softmax = [&](int j, int s, float& a0, float& a1) {
      const int k0 = j * BN;
      const int k_mn = sInfo[2 * s], k_mx = sInfo[2 * s + 1];
      const bool interior = !mask_all && k_mn != 0 && k_mn == k_mx &&
                            q_mn == k_mn && q_mx == k_mn &&
                            (!causal || k0 + BN - 1 <= warp_pos);
      float mx0 = kNegInf, mx1 = kNegInf;
      if (interior) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[nt * 4 + e] *= scale_log2;
            sc[nt * 4 + 2 + e] *= scale_log2;
            mx0 = fmaxf(mx0, sc[nt * 4 + e]);
            mx1 = fmaxf(mx1, sc[nt * 4 + 2 + e]);
          }
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
            sc[nt * 4 + e] = ok0 ? sc[nt * 4 + e] * scale_log2 : kNegInf;
            sc[nt * 4 + 2 + e] = ok1 ? sc[nt * 4 + 2 + e] * scale_log2 : kNegInf;
            mx0 = fmaxf(mx0, sc[nt * 4 + e]);
            mx1 = fmaxf(mx1, sc[nt * 4 + 2 + e]);
          }
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = exp2f(m0 - mn0);
      a1 = exp2f(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        sc[nt * 4 + 0] = exp2f(sc[nt * 4 + 0] - mn0);
        sc[nt * 4 + 1] = exp2f(sc[nt * 4 + 1] - mn0);
        sc[nt * 4 + 2] = exp2f(sc[nt * 4 + 2] - mn1);
        sc[nt * 4 + 3] = exp2f(sc[nt * 4 + 3] - mn1);
        rs0 += sc[nt * 4 + 0] + sc[nt * 4 + 1];
        rs1 += sc[nt * 4 + 2] + sc[nt * 4 + 3];
      }
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      m0 = mn0;
      m1 = mn1;
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    };

    for (int j = 0; j < n_mine; ++j) {
      const int s = j % kStages;
      const uint32_t st = sbase + L::kRing + s * L::kStage;
      mbar_wait(bar_ready + 8 * s, (j / kStages) & 1);
      // S = Q_hi K_hi + (Q_lo K_hi + Q_hi K_lo), 8 columns of D a step
      fence_regs(sc);
      fence_regs(sx);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t step = (kk / 4) * BN * 128 + (kk % 4) * 32;
        const uint64_t dq =
            sw128_desc(q_tile + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t dk = sw128_desc(st + L::kK + step, 16, 1024);
        tf32x3::wgmma_ss32(sc, dq, dk, kk > 0);
        tf32x3::wgmma_rs32(sx, qlo[kk], dk, kk > 0);
        tf32x3::wgmma_ss32(sx, dq, sw128_desc(st + L::kKlo + step, 16, 1024),
                           1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(sx);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] += sx[i];
      float a0, a1;
      softmax(j, s, a0, a1);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt * 4 + 0] *= a0;
        o[dt * 4 + 1] *= a0;
        o[dt * 4 + 2] *= a1;
        o[dt * 4 + 3] *= a1;
      }
      // P, split once: the register A fragments of P.V
      uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        tf32x3::a_from_acc(sc + kk * 4, ph[kk], pl[kk]);
      // O += P V, 32 columns of D at a time: the tile's hi-hi chain and
      // cross terms from zero, added to O in fp32
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        float big[16], small[16];
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          const uint32_t off = c * 32 * 128 + kk * 32;
          const uint64_t vh = sw128_desc(st + L::kVhi + off, 16, 1024);
          tf32x3::wgmma_rs32(big, ph[kk], vh, kk > 0);
          tf32x3::wgmma_rs32(small, pl[kk], vh, kk > 0);
          tf32x3::wgmma_rs32(small, ph[kk],
                             sw128_desc(st + L::kVlo + off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(big);
        fence_regs(small);
        fence_regs(ph);
        fence_regs(pl);
#pragma unroll
        for (int i = 0; i < 16; ++i) o[c * 16 + i] += big[i] + small[i];
      }
      release(s);
    }
    // kv tiles wholly in the future of these 64 rows: released unread
    for (int j = n_mine; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_ready + 8 * s, (j / kStages) & 1);
      release(s);
    }

    const float sl0 = l0 == 0.f ? 1.f : l0;
    const float sl1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / sl0, inv1 = 1.f / sl1;
    const long q_stride = (long)H * D;
    float* ob = out + (long)b * Lq * q_stride + (long)h * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + c4 * 2;
      if (r0 < Lq)
        *reinterpret_cast<float2*>(ob + r0 * q_stride + c) =
            make_float2(o[dt * 4 + 0] * inv0, o[dt * 4 + 1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<float2*>(ob + r1 * q_stride + c) =
            make_float2(o[dt * 4 + 2] * inv1, o[dt * 4 + 3] * inv1);
    }
    if (c4 == 0) {
      float* lb = lse + ((long)b * H + h) * Lq;
      if (r0 < Lq)
        lb[r0] = (m0 == kNegInf ? kNegInf : m0 * kLn2) + logf(sl0);
      if (r1 < Lq)
        lb[r1] = (m1 == kNegInf ? kNegInf : m1 * kLn2) + logf(sl1);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* q_seg, const void* kv_seg, void* out,
                       void* lse, int B, int H, int Hkv, int Lq, int S,
                       float sm_scale, int causal, int q_offset, int mask_all,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const auto type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map_3d(&tq, type, 4, q, (uint64_t)H * D, Lq, B, kBoxF32, 64,
                   sw) ||
      !make_map_3d(&tk, type, 4, k, (uint64_t)Hkv * D, S, B, kBoxF32,
                   kColsF32, sw) ||
      !make_map_3d(&tv, type, 4, v, (uint64_t)Hkv * D, S, B, kBoxF32,
                   kColsF32, sw))
    return cudaErrorNotSupported;
  constexpr int smem = SmemF32<D>::kAlloc;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int n_qtiles = (Lq + kRowsF32 - 1) / kRowsF32;
  dim3 grid(H, B, n_qtiles);
  fa_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<float*>(out),
      static_cast<float*>(lse), H, Hkv, Lq, S, sm_scale * kLog2e, causal,
      q_offset, n_qtiles, mask_all);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* q_seg, const void* kv_seg, void* out,
                     void* lse, int B, int H, int Hkv, int Lq, int S, int D,
                     float sm_scale, int causal, int q_offset, int mask_all,
                     int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Lq <= 0 || S <= 0 ||
      B > 65535 || q_offset < 0 || (Lq + kBlockM - 1) / kBlockM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto t) {
    using T = decltype(t);
    if (D == 128)
      return launch<T, 128>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, Lq,
                            S, sm_scale, causal, q_offset, mask_all, s);
    if (D == 64)
      return launch<T, 64>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, Lq,
                           S, sm_scale, causal, q_offset, mask_all, s);
    return cudaErrorInvalidValue;
  };
  switch (dtype) {
    case kBfloat16:
      return run(__nv_bfloat16());
    case kFloat16:
      return run(__half());
    case kFloat32:
      if (D == 128)
        return launch_f32<128>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv,
                               Lq, S, sm_scale, causal, q_offset, mask_all,
                               s);
      if (D == 64)
        return launch_f32<64>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv,
                              Lq, S, sm_scale, causal, q_offset, mask_all, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mc_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* q_seg,
                                      const void* kv_seg, void* out,
                                      void* lse, int B, int H, int Hkv,
                                      int Lq, int S, int D, float sm_scale,
                                      int causal, int q_offset, int dtype,
                                      void* stream) {
  return dispatch(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, Lq, S, D,
                  sm_scale, causal, q_offset, 0, dtype, stream);
}

// The same with every kv tile through the per-element mask: the fast-path
// test holds the two bit-equal.
extern "C" int mc_flash_attention_fwd_mask_all(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, void* out, void* lse, int B, int H, int Hkv, int Lq,
    int S, int D, float sm_scale, int causal, int q_offset, int dtype,
    void* stream) {
  return dispatch(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, Lq, S, D,
                  sm_scale, causal, q_offset, 1, dtype, stream);
}

// Dynamic shared memory of one block (bytes) at `dtype`, for the build
// report.
extern "C" int mc_flash_attention_fwd_smem(int D, int dtype) {
  if (dtype == kFloat32)
    return D == 128 ? SmemF32<128>::kAlloc : SmemF32<64>::kAlloc;
  return D == 128 ? Smem<128>::kAlloc : Smem<64>::kAlloc;
}
