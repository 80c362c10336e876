// The split-KV streaming decode kernel (flash-decoding) for Hopper
// (sm_90a), shared by the dense decode kernels (decode_attention.cu: a
// contiguous [B, S, Hkv, D] cache, or its int8 form with bf16 scales) and
// the paged one (paged_decode_attention.cu: a [num_blocks, bt, Hkv, D]
// page pool gathered through block tables).  One query token per request
// attends its cache rows [0, lengths[b]).  The two differ only in where
// token t of request b lives, a template policy `Rows`:
//
//   struct Rows {
//     static constexpr bool kGather;      // slots come from a table
//     int capacity() const;               // token slots a request has
//     int entry(int b, int t) const;      // the table entry (kGather only)
//     size_t slot(int b, int t, int entry) const;  // row of [.., Hkv, D]
//   };
//
// What bounds it: bytes.  Each request's valid K/V is read once and every
// value feeds G = Hq / Hkv multiply-adds per score and per output: GEMVs,
// far below the ~295 operations per byte the card needs before arithmetic
// matters, so there is no tensor-core work to find.  The design:
//
// * Grid (splits, Hkv * head chunks, B).  The host picks the number of
//   splits from shapes alone (B, the capacity, Hkv and the SM count;
//   kernel.py's `plan_splits`) so that small batches still fill the 132
//   SMs; it never reads `lengths` or a table.  Each split finds its slice
//   of [0, lengths[b]) on the device, in whole warp tiles; an empty slice
//   leaves m = -inf, l = 0.  With one split the block writes the output;
//   with more, each writes its f32 partial (m, l and the unnormalised [D]
//   output per query head) and counts itself done on an atomic counter:
//   the last split block of a (row, KV head) merges the partials and
//   resets the counter, so the merge costs no second launch.
// * Each of the block's 4 warps streams its own tiles of 2 KB of K rows
//   (and as many V rows) through a 3-stage ring of shared memory by
//   cp.async, 16-byte vectors, two tiles ahead of the one it computes, so
//   a block keeps ~16 KB in flight with no block-wide barrier in the loop
//   (only __syncwarp).  Rows at or past the slice are zero-filled without
//   a read.  Gathered rows: each lane reads the table entries of its rows
//   of a tile one iteration before it issues that tile's copies, so the
//   table read is not in the copies' dependent chain; entries of pages at
//   or past ceil(lengths[b] / bt) are never read, nor are their pages.
// * A cache row of D values is read by D / 8 lanes, 8 values a lane; the
//   dot product is reduced by __shfl_xor_sync inside the lane group, and
//   each group keeps its online softmax (running max, sum and its 8
//   output columns per query head) in registers, the G <= 8 query heads
//   of the KV head in a loop over registers (G > 8 is cut into chunks of
//   8 across the grid).  The groups and warps are merged once, at the end,
//   by shuffles and then through shared memory.
// * Scores live in the log2 domain (q is scaled by D**-0.5 * log2(e) in
//   f32) and use exp2f.
//
// Partial mode (the context-parallel decode's shard, models/attention.py
// gqa_decode_attention_cp): given cp_o, cp_m and cp_l, the final merge
// writes the shard's merged f32 state instead of dividing: the
// unnormalised output o [B, Hq, D], its max m [B, Hq] and its sum of
// exponentials l [B, Hq], with m converted from the log2 domain to the
// natural log (m * ln 2; o and l are the same sums in either base), so
// that ranks merge m with the plain version's units.  A shard with no
// valid row writes m = -inf, l = 0, o = 0.
//
// int8 (dense rows only): the cache moves half the bf16 cache's bytes.
// Each (token, head) scale is read once per lane group, a tile ahead, and
// folded into the score (s_k q.k) and into p (p s_v) instead of
// dequantising every value: the same arithmetic up to f32 rounding.  Rows
// at or past the length, and their scales, are never read.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_mma.cuh"

namespace repro {

constexpr int kWarps = 4;
constexpr int kSplitThreads = kWarps * 32;
constexpr int kStages = 3;              // per-warp ring depth
constexpr int kWarpTileBytes = 2048;    // K bytes per warp tile (V alike)
constexpr int kMaxHeads = 8;            // query heads a block keeps
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.6931471805599453f;

// The merged state of one output row: the output (divided), or in
// partial mode the unnormalised output, m in natural-log units and l.
template <typename T>
__device__ __forceinline__ void store_row(T* out, float* cp_o, float* cp_m,
                                          float* cp_l, size_t row, int D,
                                          int d, float O, float M, float L) {
  if (cp_o == nullptr) {
    out[row * D + d] = from_f32<T>(O / fmaxf(L, 1e-30f));
    return;
  }
  cp_o[row * D + d] = O;
  if (d == 0) {
    cp_m[row] = M * kLn2;  // -inf stays -inf
    cp_l[row] = L;
  }
}

// 8 consecutive cache values from shared memory as f32
template <typename KV>
__device__ __forceinline__ void load8(const KV* p, float (&f)[8]);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = w[i];
    const float2 x = __bfloat1622float2(h);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* p,
                                              float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = static_cast<float>(static_cast<int8_t>((u.x >> (8 * i)) & 0xff));
    f[4 + i] =
        static_cast<float>(static_cast<int8_t>((u.y >> (8 * i)) & 0xff));
  }
}

// Combine two online-softmax states (max in the log2 domain): returns the
// rescale factors of each side; a side that saw no key (m = -inf) gets 0.
__device__ __forceinline__ void merge_weights(float m_a, float m_b,
                                              float& m, float& wa,
                                              float& wb) {
  m = fmaxf(m_a, m_b);
  wa = m_a == -CUDART_INF_F ? 0.f : exp2f(m_a - m);
  wb = m_b == -CUDART_INF_F ? 0.f : exp2f(m_b - m);
}

// T: the query's and output's type; KV: the cache's (T, or int8 with
// bf16 scales k_scale / v_scale [B, S, Hkv]; null for a T cache).
// D: head size; GM: query heads held in registers (>= the block's);
// Rows: where token t of request b lives (above).
template <typename T, typename KV, int D, int GM, typename Rows>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_rows,
                    const KV* __restrict__ v_rows,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int* __restrict__ counters, float* __restrict__ cp_o,
                    float* __restrict__ cp_m, float* __restrict__ cp_l,
                    Rows rows, int Hq, int Hkv, int splits, float qscale) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static_assert(!(kInt8 && Rows::kGather), "int8 caches are dense");
  constexpr int LPR = D / 8;                     // lanes per cache row
  constexpr int RPW = 32 / LPR;                  // rows a warp takes a step
  constexpr int TW = kWarpTileBytes / (D * (int)sizeof(KV));  // tile rows
  constexpr int VPC = 16 / (int)sizeof(KV);      // values per 16-B chunk
  constexpr int CPR = D / VPC;                   // chunks per row
  constexpr int CPL = TW * CPR / 32;             // chunks per lane
  constexpr int SC = (TW + 31) / 32;             // scale rows per lane
  static_assert(TW % RPW == 0 && (TW * CPR) % 32 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const int G = Hq / Hkv;
  const int chunks = (G + GM - 1) / GM;
  const int sp = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * GM;
  const int gc = min(GM, G - g0);
  const int len = min(max(lengths[b], 0), rows.capacity());
  // this split's slice [t0, t0 + n) of [0, len), in whole warp tiles
  const int per = ((len + splits - 1) / splits + TW - 1) / TW * TW;
  const int t0 = min(len, sp * per);
  const int n = min(len, t0 + per) - t0;

  const size_t hq0 = (size_t)h * G + g0;
  float qf[GM][8], acc[GM][8], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const T* qrow = q + ((size_t)b * Hq + hq0 + g) * D + sub * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qf[g][i] = g < gc ? to_f32(qrow[i]) * qscale : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;  // between consecutive slots
  const size_t hoff = (size_t)h * D;
  KV* ring = reinterpret_cast<KV*>(smem) + (size_t)warp * kStages * 2 * TW * D;
  const int ntile = (n + TW - 1) / TW;  // the split's warp tiles, dealt
  const int mine =                      // to the warps round robin
      warp < ntile ? (ntile - warp + kWarps - 1) / kWarps : 0;

  // gathered rows: the table entries of this lane's rows of the next tile
  // to issue (0 past the slice, which is never read)
  int ent[CPL] = {};
  auto fetch = [&](int i) {
    if constexpr (Rows::kGather) {
      const int r0 = (warp + i * kWarps) * TW;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int row = r0 + (lane + 32 * c) / CPR;
        ent[c] = row < n ? rows.entry(b, t0 + row) : 0;
      }
    }
  };
  auto issue = [&](int i) {  // this warp's i-th tile into stage i % kStages
    const int r0 = (warp + i * kWarps) * TW;
    KV* ks = ring + (i % kStages) * 2 * TW * D;
    KV* vs = ks + TW * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int chunk = lane + 32 * c, row = chunk / CPR;
      const int col = (chunk % CPR) * VPC;
      const bool ok = r0 + row < n;
      const size_t off =
          ok ? rows.slot(b, t0 + r0 + row, ent[c]) * row_stride + hoff + col
             : 0;
      cp_async16(ks + row * D + col, k_rows + off, ok);
      cp_async16(vs + row * D + col, v_rows + off, ok);
    }
  };
  // int8: lane r of the warp holds the scales of rows r, r + 32, ... of
  // its i-th tile (0 past the slice, which is never read)
  auto load_scales = [&](int i, float (&ks)[SC], float (&vs)[SC]) {
    const int r0 = (warp + i * kWarps) * TW;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int row = r0 + lane + 32 * c;
      const bool ok = lane + 32 * c < TW && row < n;
      const size_t idx = rows.slot(b, t0 + row, 0) * Hkv + h;
      ks[c] = ok ? __bfloat162float(k_scale[idx]) : 0.f;
      vs[c] = ok ? __bfloat162float(v_scale[idx]) : 0.f;
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    fetch(i);
    if (i < mine) issue(i);
    cp_async_commit();
  }
  fetch(kStages - 1);
  float ksc[SC], vsc[SC], ksn[SC], vsn[SC];
#pragma unroll
  for (int c = 0; c < SC; ++c) ksc[c] = vsc[c] = ksn[c] = vsn[c] = 1.f;
  if constexpr (kInt8) {
    if (mine > 0) load_scales(0, ksc, vsc);
  }
  for (int i = 0; i < mine; ++i) {
    __syncwarp();  // every lane is done with stage (i - 1) % kStages
    if (i + kStages - 1 < mine) issue(i + kStages - 1);
    cp_async_commit();
    fetch(i + kStages);
    if constexpr (kInt8) {
      if (i + 1 < mine) load_scales(i + 1, ksn, vsn);
    }
    cp_async_wait<kStages - 1>();  // this lane's copies of tile i landed
    __syncwarp();                  // and every lane's
    const KV* ks = ring + (i % kStages) * 2 * TW * D;
    const KV* vs = ks + TW * D;
    const int r0 = (warp + i * kWarps) * TW;
#pragma unroll
    for (int rr0 = 0; rr0 < TW; rr0 += RPW) {
      const int rr = rr0 + grp;
      float kf[8];
      load8(ks + rr * D + sub * 8, kf);
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) a = fmaf(qf[g][j], kf[j], a);
        s[g] = a;
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o /= 2)
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] += __shfl_xor_sync(kFull, s[g], o);
      float kscale = 1.f, vscale = 1.f;
      if constexpr (kInt8) {
        kscale = __shfl_sync(kFull, ksc[rr0 / 32], rr % 32);
        vscale = __shfl_sync(kFull, vsc[rr0 / 32], rr % 32);
      }
      if (r0 + rr < n) {
        float vf[8];
        load8(vs + rr * D + sub * 8, vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < gc) {
            const float sg = s[g] * kscale;
            const float mn = fmaxf(m[g], sg);
            const float a = exp2f(m[g] - mn);  // 0 while m = -inf
            const float p = exp2f(sg - mn);
            l[g] = fmaf(l[g], a, p);
            const float pv = p * vscale;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[g][j] = fmaf(pv, vf[j], acc[g][j] * a);
            m[g] = mn;
          }
        }
      }
    }
    if constexpr (kInt8) {
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        ksc[c] = ksn[c];
        vsc[c] = vsn[c];
      }
    }
  }
  cp_async_wait<0>();

  // merge the lane groups of each warp by shuffles ...
#pragma unroll
  for (int o = LPR; o < 32; o *= 2) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], o);
      const float lo = __shfl_xor_sync(kFull, l[g], o);
      float mn, wa, wb;
      merge_weights(m[g], mo, mn, wa, wb);
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ao = __shfl_xor_sync(kFull, acc[g][j], o);
        acc[g][j] = acc[g][j] * wa + ao * wb;
      }
      m[g] = mn;
    }
  }
  // ... then the warps, once, through shared memory (the ring's bytes)
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(smem);  // [kWarps][GM][D]
  float* red_m = red_o + kWarps * GM * D;         // [kWarps][GM]
  float* red_l = red_m + kWarps * GM;             // [kWarps][GM]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red_o[(warp * GM + g) * D + sub * 8 + j] = acc[g][j];
      if (sub == 0) {
        red_m[warp * GM + g] = m[g];
        red_l[warp * GM + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gc * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    float M = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * GM + g]);
    float O = 0.f, L = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_m[w * GM + g];
      if (mw != -CUDART_INF_F) {
        const float f = exp2f(mw - M);
        O = fmaf(red_o[(w * GM + g) * D + d], f, O);
        L = fmaf(red_l[w * GM + g], f, L);
      }
    }
    const size_t row = (size_t)b * Hq + hq0 + g;
    if (splits == 1) {
      store_row(out, cp_o, cp_m, cp_l, row, D, d, O, M, L);
    } else {
      const size_t pi = row * splits + sp;
      part_o[pi * D + d] = O;
      if (d == 0) {
        part_ml[2 * pi] = M;
        part_ml[2 * pi + 1] = L;
      }
    }
  }
  if (splits == 1) return;

  // The last split block of this (row, KV head, head chunk) to finish
  // merges every split's partials; its counter goes back to 0 for the
  // next launch.
  int* last = reinterpret_cast<int*>(red_l + kWarps * GM);  // in smem
  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    int* count = counters + (size_t)b * gridDim.y + blockIdx.y;
    *last = atomicAdd(count, 1) == splits - 1;
    if (*last) *count = 0;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int e = threadIdx.x; e < gc * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    const size_t row = (size_t)b * Hq + hq0 + g;
    const float* ml = part_ml + row * splits * 2;
    float M = -CUDART_INF_F;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, __ldcg(ml + 2 * s));
    float O = 0.f, L = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float mw = __ldcg(ml + 2 * s);
      if (mw != -CUDART_INF_F) {
        const float f = exp2f(mw - M);
        O = fmaf(__ldcg(part_o + (row * splits + s) * D + d), f, O);
        L = fmaf(__ldcg(ml + 2 * s + 1), f, L);
      }
    }
    store_row(out, cp_o, cp_m, cp_l, row, D, d, O, M, L);
  }
}

// The launch's arguments apart from the template: K and V rows (cache or
// pages), int8 scales (null for a float cache), lengths, output, split
// scratch (null for one split), and the partial mode's f32 outputs
// (null, the default, to write `out`).
struct SplitArgs {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths;
  void* out;
  int B, Hq, Hkv, splits;
  void *part_o, *part_ml, *counters;
  void *cp_o = nullptr, *cp_m = nullptr, *cp_l = nullptr;
};

template <typename T, typename KV, int D, int GM, typename Rows>
cudaError_t launch_split(const SplitArgs& a, Rows rows,
                         cudaStream_t stream) {
  const size_t ring = (size_t)kWarps * kStages * 2 * kWarpTileBytes;
  const size_t red = sizeof(float) * ((size_t)kWarps * GM * (D + 2) + 1);
  const size_t smem = ring > red ? ring : red;
  cudaError_t err = set_smem(decode_split_kernel<T, KV, D, GM, Rows>, smem);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv, chunks = (G + GM - 1) / GM;
  const float qscale = static_cast<float>(
      1.0 / std::sqrt(static_cast<double>(D)) * kLog2e);
  decode_split_kernel<T, KV, D, GM, Rows>
      <<<dim3(a.splits, a.Hkv * chunks, a.B), kSplitThreads, smem,
         stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
          static_cast<const KV*>(a.v),
          static_cast<const __nv_bfloat16*>(a.k_scale),
          static_cast<const __nv_bfloat16*>(a.v_scale),
          static_cast<const int*>(a.lengths), static_cast<T*>(a.out),
          static_cast<float*>(a.part_o), static_cast<float*>(a.part_ml),
          static_cast<int*>(a.counters), static_cast<float*>(a.cp_o),
          static_cast<float*>(a.cp_m), static_cast<float*>(a.cp_l), rows,
          a.Hq, a.Hkv, a.splits, qscale);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, typename Rows>
cudaError_t launch_split_d(const SplitArgs& a, Rows rows,
                           cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G == 1) return launch_split<T, KV, D, 1>(a, rows, stream);
  if (G == 2) return launch_split<T, KV, D, 2>(a, rows, stream);
  if (G <= 4) return launch_split<T, KV, D, 4>(a, rows, stream);
  return launch_split<T, KV, D, kMaxHeads>(a, rows, stream);
}

// Head sizes 32, 64 and 128; anything else is refused.
template <typename T, typename KV, typename Rows>
cudaError_t launch_split_any(const SplitArgs& a, int D, Rows rows,
                             cudaStream_t stream) {
  switch (D) {
    case 32: return launch_split_d<T, KV, 32>(a, rows, stream);
    case 64: return launch_split_d<T, KV, 64>(a, rows, stream);
    case 128: return launch_split_d<T, KV, 128>(a, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline bool bad_split_args(const SplitArgs& a, int capacity) {
  const bool cp = a.cp_o != nullptr;
  return a.B < 0 || capacity <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
         a.splits < 1 || (cp && (a.cp_m == nullptr || a.cp_l == nullptr)) ||
         (a.splits > 1 && (a.part_o == nullptr || a.part_ml == nullptr ||
                           a.counters == nullptr));
}

}  // namespace repro
