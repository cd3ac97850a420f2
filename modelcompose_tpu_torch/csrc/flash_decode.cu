// Flash-decode (kernel K2) for Hopper, sm_90a: one-token attention per
// batch row over one layer of the layer-stacked KV cache, in one launch.
//
// Replaces the Pallas TPU kernel modelcompose_tpu/ops/flash_decode.py
// `_fd_kernel` (driven by `flash_decode_attention`); its semantics are
// those of the XLA loop modelcompose_tpu/ops/attention.py
// `decode_attention`:
//     logits = (q * scale) . k  [* k_scale]   masked to pos < kv_len[b]
//     out    = sum softmax(logits) [* v_scale] v
// with the int8 cache's per-vector scales factored out of both
// contractions, so the int8 bytes are what stream from memory.
//
// What bounds it on the H100: device-memory bytes.  A decode step reads
// this layer's valid cache once (int8: 2 * kv_len * Hkv * D bytes per row,
// plus 8 bytes of scales per position and head) and does ~2 flops a byte.
// At a batch of one the whole read fits in one wave of blocks, so a
// launch costs the load plus one block's work after its data lands plus
// the combine; the design shortens each:
//   - split-KV: one block per (split of 128 positions, kv head, batch
//     row), so even a batch of one puts hundreds of blocks on the 132 SMs
//     (832 at the MCUB-4 decode, six per SM); splits past kv_len exit at
//     once.  128 positions beat 256 at batch 1 and 2 (a chip probe,
//     PERF.md): half the work per block after its data lands;
//   - at block start one thread asks TMA for the split's whole K and V
//     (64-row boxes of a 3-D map over [layer * B + b][S][Hkv * D], so
//     nothing past the row's cache is read), one mbarrier per box: 32 KB
//     in flight per int8 block;
//   - eight warps, each one pass over its own 16 rows as soon as their box
//     lands: per step a team of lanes reads 16 bytes each of a K row, the
//     row's logit is reduced in the team and broadcast, and the same step
//     folds the rows' V (four elements a lane) into a per-warp online
//     softmax (running max, sum and accumulator), so there is no
//     block-wide softmax pass; the warps merge through shared memory;
//   - int8 becomes fp32 by a byte permute and an add (exact), not by the
//     quarter-rate conversion unit;
//   - the combine of the splits is fused: each block writes its partial
//     (m, l, acc) and bumps an atomic counter of its (b, kv head); the
//     last block to finish combines every split (a block-wide max, then
//     each output element sums its weighted partials with the loads in
//     flight together) and resets the counter, so a decode step is one
//     launch per layer;
//   - on the host, the tensor maps of a cache are encoded once and kept,
//     and the shared-memory attribute is set once per instantiation, so a
//     launch costs the host little more than the launch itself.
// `layer` is an offset into the stacked cache, so no per-layer slice is
// ever materialized, and any S is taken.
//
// q and out are of the model's type QT, bf16, fp16 or fp32; the cache is
// of QT too, or int8.  Everything inside is fp32, as in the JAX kernel
// (which upcasts q, k and v): only the loads and the one store convert.
// At fp32 a 16-byte load holds 4 elements (a K row is 32 lanes' loads at
// D = 128, one row a warp step) and the block's cache tiles take 128 KB.
//
// Layouts: q [B, H, D] QT; caches [NL, B, S, Hkv, D] QT, or int8 with
// fp32 scales [NL, B, S, Hkv] (the trailing 1 of [..., Hkv, 1] dropped);
// kv_len [B] int32; partials m, l [B, H, n_splits] and acc
// [B, H, n_splits, D] fp32; counters [B * Hkv] uint32, zero between
// launches; out [B, H, D] QT.  D in {64, 128}; the GQA group H / Hkv in
// {1, 2, 4, 8}.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 128;               // cache positions per block
constexpr int kBoxRows = 64;              // cache rows per TMA box
constexpr int kBoxes = kSplit / kBoxRows;
constexpr int kRowsPerWarp = kSplit / kWarps;
constexpr float kNegInf = -1e30f;
static_assert(kBoxRows % kRowsPerWarp == 0, "a warp's rows sit in one box");

template <typename T>
__host__ __device__ constexpr bool is_int8() {
  return std::is_same<T, int8_t>::value;
}

// A bf16, fp16 or fp32 value as fp32, and fp32 rounded to one (nearest
// even).
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float f) {
  if constexpr (std::is_same<T, float>::value)
    return f;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(f);
  else
    return __float2half_rn(f);
}

// Two bf16 or fp16 values of a word as fp32.
template <typename T>
__device__ __forceinline__ void cvt2(uint32_t w, float* f) {
  float2 x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  else
    x = __half22float2(*reinterpret_cast<__half2*>(&w));
  f[0] = x.x;
  f[1] = x.y;
}

// Sixteen bytes of a cache row as fp32 (16 int8, 8 bf16 or fp16, or 4
// fp32).
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  } else if constexpr (is_int8<T>()) {
    cvt4(raw.x, f);
    cvt4(raw.y, f + 4);
    cvt4(raw.z, f + 8);
    cvt4(raw.w, f + 12);
  } else {
    cvt2<T>(raw.x, f);
    cvt2<T>(raw.y, f + 2);
    cvt2<T>(raw.z, f + 4);
    cvt2<T>(raw.w, f + 6);
  }
}

// N (2 or 4) consecutive cache elements as fp32.
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* f) {
  if constexpr (std::is_same<T, float>::value && N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  } else if constexpr (std::is_same<T, float>::value) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x;
    f[1] = x.y;
  } else if constexpr (is_int8<T>() && N == 4) {
    cvt4(*reinterpret_cast<const uint32_t*>(p), f);
  } else if constexpr (is_int8<T>()) {
    float t[4];
    cvt4(*reinterpret_cast<const uint16_t*>(p), t);
    f[0] = t[0];
    f[1] = t[1];
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    cvt2<T>(raw.x, f);
    cvt2<T>(raw.y, f + 2);
  } else {
    cvt2<T>(*reinterpret_cast<const uint32_t*>(p), f);
  }
}

// Shared memory of one block, in bytes from a 128-aligned base.
template <int D, int G, typename T>
struct Smem {
  static constexpr int kRow = D * static_cast<int>(sizeof(T));
  static constexpr int kK = 0;
  static constexpr int kV = kK + kSplit * kRow;
  static constexpr int kScale = kV + kSplit * kRow;      // float [2][kSplit]
  static constexpr int kAcc = kScale + 2 * kSplit * 4;   // float [kWarps][G][D]
  static constexpr int kML = kAcc + kWarps * G * D * 4;  // float [2][kWarps][G]
  static constexpr int kRed = kML + 2 * kWarps * G * 4;  // float [kWarps][G]
  static constexpr int kBar = kRed + kWarps * G * 4 + 8;  // k[], v[]
  static constexpr int kFlag = kBar + 2 * kBoxes * 8;
  static constexpr int kBytes = kFlag + 16;
  static constexpr int kAlloc = kBytes + 128;  // room to align the base
};
static_assert(Smem<128, 8, float>::kAlloc <= 232448,
              "the widest block (fp32 cache, group 8) fits an SM");

// Block-wide max of G values per thread; every thread gets the result.
template <int G>
__device__ __forceinline__ void block_max(float v[G], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[g] = fmaxf(v[g], __shfl_xor_sync(0xffffffffu, v[g], off));
    if (lane == 0) red[warp * G + g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float r = red[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w * G + g]);
    v[g] = r;
  }
}

template <int D, int G, typename T, typename QT>
__global__ void __launch_bounds__(kThreads)
fd_split_kernel(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const QT* __restrict__ q,
                const float* __restrict__ ks, const float* __restrict__ vs,
                const int* __restrict__ kv_len, float* __restrict__ part_m,
                float* __restrict__ part_l, float* __restrict__ part_acc,
                unsigned* __restrict__ counters,
                QT* __restrict__ out, int B, int H, int Hkv,
                int S, int n_splits, int layer, float sm_scale) {
  using L = Smem<D, G, T>;
  constexpr int kLanes = L::kRow / 16;     // lanes per K row, 16 B each
  constexpr int kElems = 16 / sizeof(T);   // K elements per lane
  constexpr int kStep = 32 / kLanes;       // K rows per warp step
  constexpr int kDims = D / 32;            // V elements per lane
  static_assert(kRowsPerWarp % kStep == 0, "whole steps per warp");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* sScK = reinterpret_cast<float*>(smem + L::kScale);
  float* sScV = sScK + kSplit;
  float* sAcc = reinterpret_cast<float*>(smem + L::kAcc);
  float* sM = reinterpret_cast<float*>(smem + L::kML);
  float* sL = sM + kWarps * G;
  float* sRed = reinterpret_cast<float*>(smem + L::kRed);
  int* sLast = reinterpret_cast<int*>(smem + L::kFlag);
  const T* sK = reinterpret_cast<const T*>(smem + L::kK);
  const T* sV = reinterpret_cast<const T*>(smem + L::kV);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bar_k = sbase + L::kBar;     // + 8 * box
  const uint32_t bar_v = bar_k + 8 * kBoxes;  // + 8 * box

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = min(kv_len[b], S);
  if (len <= 0) {  // nothing to attend to: the combine's empty-row output
    if (sp == 0)
      for (int i = tid; i < G * D; i += kThreads)
        out[((long)b * H + hk * G) * D + i] = from_f<QT>(0.f);
    return;
  }
  const int s0 = sp * kSplit;
  const int s1 = min(s0 + kSplit, len);
  if (s0 >= s1) return;  // past kv_len: the combine skips this split
  const int n = s1 - s0;
  const int n_live = (len + kSplit - 1) / kSplit;
  const int boxes = (n + kBoxRows - 1) / kBoxRows;

  if (tid == 0) {
    for (int i = 0; i < 2 * kBoxes; ++i) mbar_init(bar_k + 8 * i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    const int c2 = layer * B + b;
    for (int i = 0; i < boxes; ++i) {
      mbar_arrive_expect_tx(bar_k + 8 * i, kBoxRows * L::kRow);
      tma_load_3d(sbase + L::kK + i * kBoxRows * L::kRow, &tk, bar_k + 8 * i,
                  hk * D, s0 + i * kBoxRows, c2);
      mbar_arrive_expect_tx(bar_v + 8 * i, kBoxRows * L::kRow);
      tma_load_3d(sbase + L::kV + i * kBoxRows * L::kRow, &tv, bar_v + 8 * i,
                  hk * D, s0 + i * kBoxRows, c2);
    }
  }

  // Scales of this split and this lane's slice of the q heads, while the
  // cache is in flight.  Vector (layer, b, pos, hk) is at index
  // ((layer * B + b) * S + pos) * Hkv + hk.
  const long vec0 = ((long)layer * B + b) * S + s0;
  for (int i = tid; i < n; i += kThreads) {
    sScK[i] = ks != nullptr ? ks[(vec0 + i) * Hkv + hk] : 1.f;
    sScV[i] = vs != nullptr ? vs[(vec0 + i) * Hkv + hk] : 1.f;
  }
  const int team = lane / kLanes, tl = lane % kLanes;
  float qr[G][kElems];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const QT* qp = q + ((long)b * H + hk * G + g) * D + tl * kElems;
#pragma unroll
    for (int e = 0; e < kElems; ++e) qr[g][e] = to_f(qp[e]) * sm_scale;
  }
  __syncthreads();  // scales visible

  // One pass per warp over its rows: logits, then the online-softmax
  // update of this warp's (m, l, acc) with the same rows' V.
  float m[G], l[G], acc[G][kDims];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[g][e] = 0.f;
  }
  const int r_begin = warp * kRowsPerWarp;
  if (r_begin < n) {
    const int box = r_begin / kBoxRows;
    mbar_wait(bar_k + 8 * box, 0);
    mbar_wait(bar_v + 8 * box, 0);
    const int r_end = min(n, r_begin + kRowsPerWarp);
    for (int r0 = r_begin; r0 < r_end; r0 += kStep) {
      // this team's row: its logit for every head, reduced in the team
      const int r = r0 + team;
      float kf[kElems];
      load16(sK + r * D + tl * kElems, kf);  // rows past n: in the box, unused
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int e = 0; e < kElems; e += 2) {
          a0 += qr[g][e] * kf[e];
          a1 += qr[g][e + 1] * kf[e + 1];
        }
        float dot = a0 + a1;
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[g] = r < n ? dot * sScK[r] : kNegInf;
      }
      // every row of the step to every lane; then the softmax update
      float p[kStep][G];
      float mx[G];
#pragma unroll
      for (int g = 0; g < G; ++g) mx[g] = m[g];
#pragma unroll
      for (int rr = 0; rr < kStep; ++rr)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          p[rr][g] = __shfl_sync(0xffffffffu, s[g], rr * kLanes);
          mx[g] = fmaxf(mx[g], p[rr][g]);
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float alpha = expf(m[g] - mx[g]);
        m[g] = mx[g];
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int rr = 0; rr < kStep; ++rr) {
        const int row = r0 + rr;
        if (row < n) {  // warp-uniform
          float vf[kDims];
          load_n<kDims>(sV + row * D + lane * kDims, vf);
          const float vsc = sScV[row];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float e_ = expf(p[rr][g] - m[g]);
            l[g] += e_;
            const float w = e_ * vsc;
#pragma unroll
            for (int e = 0; e < kDims; ++e) acc[g][e] += w * vf[e];
          }
        }
      }
    }
  }

  // Merge the warps: each (g, d) of this split's partial.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      sAcc[(warp * G + g) * D + lane * kDims + e] = acc[g][e];
    if (lane == 0) {
      sM[warp * G + g] = m[g];
      sL[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sM[w * G + g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sM[w * G + g] - mm);  // 0 for a warp with no rows
      a += c * sAcc[(w * G + g) * D + d];
      ll += c * sL[w * G + g];
    }
    const long slot = ((long)b * H + hk * G + g) * n_splits + sp;
    part_acc[slot * D + d] = a;
    if (d == 0) {
      part_m[slot] = mm;
      part_l[slot] = ll;
    }
  }

  // The last split of this (b, kv head) to finish combines them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned done = atomicAdd(&counters[b * Hkv + hk], 1u);
    *sLast = done == static_cast<unsigned>(n_live - 1);
  }
  __syncthreads();
  if (!*sLast) return;
  __threadfence();
  const long base0 = ((long)b * H + hk * G) * n_splits;  // head g: + g * n_splits
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = -INFINITY;
    for (int s = tid; s < n_live; s += kThreads)
      mx[g] = fmaxf(mx[g], __ldcg(part_m + base0 + g * n_splits + s));
  }
  block_max<G>(mx, sRed);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const long base = base0 + g * n_splits;
    float a = 0.f, ll = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) {
      const float w = expf(__ldcg(part_m + base + s) - mx[g]);
      ll += w * __ldcg(part_l + base + s);
      a += w * __ldcg(part_acc + (base + s) * D + d);
    }
    out[((long)b * H + hk * G + g) * D + d] =
        from_f<QT>(a / fmaxf(ll, 1e-30f));
  }
  if (tid == 0) counters[b * Hkv + hk] = 0;  // ready for the next launch
}

// The tensor map of a stacked cache [NL * B][S][Hkv * D] with a
// [64][D] box, encoded once per cache and kept: a decode loop reuses the
// same few caches for every step and layer.  Locked: ctypes releases the
// GIL, so two host threads may launch at once.
bool cache_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
               int elem_bytes, uint64_t cols, uint64_t rows, uint64_t planes,
               uint32_t box0) {
  struct Entry {
    const void* base;
    CUtensorMapDataType type;
    int elem_bytes;
    uint64_t cols, rows, planes;
    uint32_t box0;
    CUtensorMap map;
  };
  static Entry entries[16];
  static int n_entries = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_entries; ++i) {
    const Entry& e = entries[i];
    if (e.base == base && e.type == type && e.elem_bytes == elem_bytes &&
        e.cols == cols &&
        e.rows == rows && e.planes == planes && e.box0 == box0) {
      *map = e.map;
      return true;
    }
  }
  if (!make_map_3d(map, type, elem_bytes, base, cols, rows, planes, box0,
                   kBoxRows, CU_TENSOR_MAP_SWIZZLE_NONE))
    return false;
  entries[next] =
      Entry{base, type, elem_bytes, cols, rows, planes, box0, *map};
  next = (next + 1) % 16;
  n_entries = n_entries < 16 ? n_entries + 1 : 16;
  return true;
}

template <int D, int G, typename T, typename QT>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ks, const void* vs, const void* kv_len,
                   void* part_m, void* part_l, void* part_acc,
                   void* counters, void* out, int NL, int B, int H, int Hkv,
                   int S, int n_splits, int layer, float sm_scale,
                   cudaStream_t stream) {
  const uint64_t planes = (uint64_t)NL * B;
  CUtensorMap tk, tv;
  const auto type =
      is_int8<T>() ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : tma_type<T>();
  if (!cache_map(&tk, kc, type, sizeof(T), (uint64_t)Hkv * D, S, planes,
                 D) ||
      !cache_map(&tv, vc, type, sizeof(T), (uint64_t)Hkv * D, S, planes, D))
    return cudaErrorNotSupported;
  constexpr int smem = Smem<D, G, T>::kAlloc;
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fd_split_kernel<D, G, T, QT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  dim3 grid(n_splits, Hkv, B);
  fd_split_kernel<D, G, T, QT><<<grid, kThreads, smem, stream>>>(
      tk, tv, static_cast<const QT*>(q),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(kv_len), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc),
      static_cast<unsigned*>(counters), static_cast<QT*>(out), B,
      H, Hkv, S, n_splits, layer, sm_scale);
  return cudaGetLastError();
}

template <int D, typename T, typename QT>
cudaError_t dispatch_group(int G, const void* q, const void* kc,
                           const void* vc, const void* ks, const void* vs,
                           const void* kv_len, void* pm, void* pl, void* pa,
                           void* cnt, void* out, int NL, int B, int H,
                           int Hkv, int S, int n_splits, int layer,
                           float sm_scale, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<D, 1, T, QT>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, cnt, out,
                             NL, B, H, Hkv, S, n_splits, layer, sm_scale, st);
    case 2:
      return launch<D, 2, T, QT>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, cnt, out,
                             NL, B, H, Hkv, S, n_splits, layer, sm_scale, st);
    case 4:
      return launch<D, 4, T, QT>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, cnt, out,
                             NL, B, H, Hkv, S, n_splits, layer, sm_scale, st);
    case 8:
      return launch<D, 8, T, QT>(q, kc, vc, ks, vs, kv_len, pm, pl, pa, cnt, out,
                             NL, B, H, Hkv, S, n_splits, layer, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mc_flash_decode_split_len(void) { return kSplit; }

// Dynamic shared memory of one block (bytes) at GQA group 1 over an int8
// cache (`quantized`) or one of q's `dtype`, for the build report.
extern "C" int mc_flash_decode_smem(int D, int quantized, int dtype) {
  if (quantized)
    return D == 128 ? Smem<128, 1, int8_t>::kAlloc
                    : Smem<64, 1, int8_t>::kAlloc;
  if (dtype == kFloat32)
    return D == 128 ? Smem<128, 1, float>::kAlloc
                    : Smem<64, 1, float>::kAlloc;
  return D == 128 ? Smem<128, 1, __nv_bfloat16>::kAlloc
                  : Smem<64, 1, __nv_bfloat16>::kAlloc;
}

extern "C" int mc_flash_decode(const void* q, const void* kc, const void* vc,
                               const void* ks, const void* vs,
                               const void* kv_len, void* part_m,
                               void* part_l, void* part_acc, void* counters,
                               void* out, int NL, int B, int H, int Hkv,
                               int S, int D, int layer, int quantized,
                               int dtype, float sm_scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 ||
      S <= 0 || layer < 0 || layer >= NL || (quantized && (!ks || !vs)) ||
      (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int n_splits = (S + kSplit - 1) / kSplit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The cache's type T (int8, or q's) and q's type QT.
  auto run = [&](auto cache, auto qt) {
    using T = decltype(cache);
    using QT = decltype(qt);
    const void* kss = quantized ? ks : nullptr;
    const void* vss = quantized ? vs : nullptr;
    if (D == 128)
      return dispatch_group<128, T, QT>(G, q, kc, vc, kss, vss, kv_len,
                                        part_m, part_l, part_acc, counters,
                                        out, NL, B, H, Hkv, S, n_splits,
                                        layer, sm_scale, st);
    return dispatch_group<64, T, QT>(G, q, kc, vc, kss, vss, kv_len, part_m,
                                     part_l, part_acc, counters, out, NL, B,
                                     H, Hkv, S, n_splits, layer, sm_scale,
                                     st);
  };
  switch (dtype) {
    case kBfloat16:
      return quantized ? run(int8_t(), __nv_bfloat16())
                       : run(__nv_bfloat16(), __nv_bfloat16());
    case kFloat16:
      return quantized ? run(int8_t(), __half()) : run(__half(), __half());
    case kFloat32:
      return quantized ? run(int8_t(), float()) : run(float(), float());
    default:
      return cudaErrorInvalidValue;
  }
}
