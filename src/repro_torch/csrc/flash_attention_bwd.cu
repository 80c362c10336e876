// The gradient of dense GQA prefill attention for Hopper (sm_90a), in f32
// and bf16: dQ, dK and dV of out = softmax(scale * Q.K^T, masked) . V for
// every mode the forward kernel (flash_attention.cu) takes: causal,
// sliding window, and full mode with Sq != Sk and a key bound kv_len.
//
// Replaces no TPU kernel: the JAX package differentiates its plain jnp
// attention and has no backward Pallas kernel.  The port's forward is a
// hand-written kernel reached through ctypes, which autograd cannot see
// through, so its gradient is a kernel too (ops.py wraps the pair in a
// torch.autograd.Function).
//
// Algorithm: the FlashAttention-2 backward.  The forward stores each query
// row's log-sum-exp lse of its scaled scores, so a tile recomputes its
// probabilities as P = exp(scale * q.k - lse) without a softmax pass.
// With delta = rowsum(dO o O), dP = dO . V^T and dS = P o (dP - delta):
//   dV = P^T . dO,   dK = scale * dS^T . Q,   dQ = scale * dS . K.
// Two launches a call, on one stream, no atomics, so two runs of one call
// give the same bits:
//   flash_bwd_delta_kernel: delta for every query row, into a scratch.
//   flash_bwd_kernel: two kinds of 4-warp block in one grid, so that each
//   kind fills the SMs the other's short blocks leave idle (the causal
//   triangle gives blocks from 1 to 12 tiles of work):
//   * dQ blocks, one per (row, KV head, 64 packed query rows), the
//     forward's tiling, a warp per 16 rows: over the 32-key K/V tiles its
//     rows can see, S = Q.K^T and dP = dO.V^T, P and dS in the
//     accumulators' registers, dQ += dS.K with dS the A operand as it
//     stands; dQ is written once.
//   * dK/dV blocks, a cluster of two per (row, KV head, 64 keys), a warp
//     per 16 keys: each block walks half of the 64-row Q/dO steps that
//     see its keys, S^T = K.Q^T and dP^T = V.dO^T, P^T and dS^T in
//     registers, dV += P^T.dO and dK += dS^T.Q with P^T and dS^T the A
//     operands; rank 1 hands its sums to rank 0 through the cluster's
//     shared memory, which adds them in a fixed order and writes dK, dV.
//     Rows are packed as the forward packs them (row r of the Sq * G rows
//     of a KV head is position r / G, query head h * G + r % G), so the
//     sum over the G query heads of a group is the walk over rows itself.
// K/V and Q/dO tiles arrive by 16-byte cp.async (lse and delta by 4-byte
// ones) in a two-stage ring, the next tile in flight while this one is
// used; neither kind reads a key at or past kv_len (staged as zeros, so
// NaN there cannot reach a product) and those keys get dK = dV = 0.  Masks
// are built only on the tiles that straddle an edge (diagonal, window,
// bound, ragged rows).
//
// Products: flash_mma.cuh's warp tile step on mma.sync, f32 in 3xTF32
// (hi/lo split with rna rounding, lo.lo dropped: the reference's 2e-4 hold
// with TF32 off), bf16 in m16n8k16 (B operands by ldmatrix).  An f32 tile
// that four warps read as B operands (the dQ block's K/V tile, at D <= 64
// where its lo halves fit) is split once, in shared memory.
// Accumulators, P, dS before rounding, lse and delta are f32; dQ, dK and
// dV are written in the input's dtype.
//
// What bounds it: at smollm-135m's training call (B 8, S 256, 9/3 heads of
// 64, causal) the five products over the causal pairs are 1.52 GFLOP
// against 25 MB (f32) of inputs and outputs: bound by operations in f32
// (3xTF32 at 495 / 3 TFLOP/s), by bytes in bf16.  The grid there is 24 x
// (8 dK/dV + 12 dQ) blocks, two resident an SM (registers and shared
// memory), 480 blocks over 264 slots; the kernel issues some ten
// instructions a tensor-core product (fragment loads, the f32 splits, the
// softmax recompute) from two warps a scheduler, and that issue, not the
// tensor cores, sets its time.
#include <cooperative_groups.h>

#include <cmath>

#include "attention_common.cuh"
#include "flash_mma.cuh"

namespace repro {
namespace {

constexpr int kDqRows = 64;      // packed query rows a dQ block
constexpr int kDqKeys = 32;      // keys a staged K/V tile
constexpr int kKvKeys = 64;      // keys a dK/dV block
constexpr int kKvRows = 64;      // packed query rows a dK/dV step
constexpr int kBwdThreads = 128;  // a block of either kind: 4 warps
static_assert(kKvKeys / 16 * 32 == kBwdThreads, "a dK/dV warp per 16 keys");

template <typename T, int D>
struct BwdShape {
  static constexpr int LD = D + 8;  // row stride in elements
  // the dQ block's f32 K/V tile, read by its four warps as B operands,
  // is split into tf32 hi and lo once, in shared memory (split_tile),
  // where its lo halves fit beside two blocks an SM
  static constexpr bool SPLIT = sizeof(T) == 4 && D <= 64;
  static constexpr size_t DQ_SMEM =
      sizeof(float) * 2 * kDqRows +
      sizeof(T) * LD * (2 * kDqRows + (SPLIT ? 6 : 4) * kDqKeys);
  static constexpr size_t KV_SMEM =
      sizeof(float) * 4 * kKvRows +
      sizeof(T) * LD * (2 * kKvKeys + 4 * kKvRows);
  static constexpr size_t SMEM = DQ_SMEM > KV_SMEM ? DQ_SMEM : KV_SMEM;
};

// A key at kp is visible to a query at qp under the call's mask (k_end:
// the key bound, or the end of the block's keys).
__device__ __forceinline__ bool visible(int qp, int kp, int k_end,
                                        int causal, int window) {
  return kp < k_end && (!causal || kp <= qp) &&
         (window <= 0 || qp - kp < window);
}

// delta = rowsum(dO o O) in f32 for every row of [B, Sq, Hq]: 8 lanes a
// row, each 16 bytes of dO and O at a time.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  constexpr int E = 16 / sizeof(T);  // values a 16-byte load
  const int row = (blockIdx.x * 256 + threadIdx.x) / 8, lane = threadIdx.x & 7;
  float sum = 0.f;
  if (row < rows) {
#pragma unroll
    for (int c = lane * E; c < D; c += 8 * E) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)row * D + c);
      const uint4 d =
          *reinterpret_cast<const uint4*>(dout + (size_t)row * D + c);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&d);
#pragma unroll
      for (int i = 0; i < E; ++i) sum = fmaf(to_f32(y[i]), to_f32(x[i]), sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (row < rows && lane == 0) delta[row] = sum;
}

// dQ for the 64 packed query rows of tile `bx` of (KV head h, batch row b).
template <typename T, int D>
__device__ __forceinline__ void dq_block(
    int bx, int h, int b, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
    int window, int kv_len, float scale, float scale_log2) {
  using F = Frag<T>;
  constexpr int LD = D + 8, BN = kDqKeys, KS = F::KS, NT = BN / 8;
  extern __shared__ float4 smem4[];
  float* ls = reinterpret_cast<float*>(smem4);  // [64] lse * log2(e)
  float* dls = ls + kDqRows;                    // [64] delta
  T* qs = reinterpret_cast<T*>(dls + kDqRows);  // [64][LD]
  T* dos = qs + kDqRows * LD;                   // [64][LD]
  T* ks = dos + kDqRows * LD;                   // [2][BN][LD]
  T* vs = ks + 2 * BN * LD;                     // [2][BN][LD]
  constexpr bool SPLIT = BwdShape<T, D>::SPLIT;
  T* kl = vs + 2 * BN * LD;                     // [BN][LD] lo halves
  T* vl = kl + BN * LD;                         // [BN][LD]

  const int G = Hq / Hkv;
  const int r0 = bx * kDqRows;
  const int R = min(kDqRows, Sq * G - r0);
  const int w = threadIdx.x / 32, t = lane_t();
  auto qrow = [&](int r) {  // packed row r -> row index of [B, Sq, Hq]
    const int row = r0 + r;
    return ((size_t)b * Sq + row / G) * Hq + (size_t)h * G + row % G;
  };
  // keys any row of this tile can see: [k_lo, k_hi), as in the forward
  const int p_lo = r0 / G, p_hi = (r0 + R - 1) / G;
  const int k_hi = causal ? min(kv_len, p_hi + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;
  auto stage_kv = [&](int j) {  // tile j into stage j % 2
    const int c0 = k_lo + j * BN;
    auto kv_row = [&](const T* x, int i) {
      return c0 + i < k_hi ? x + (((size_t)b * Sk + c0 + i) * Hkv + h) * D
                           : nullptr;
    };
    stage_tile<T, D, kBwdThreads>(ks + (j & 1) * BN * LD, LD, BN, k,
                                  [&](int i) { return kv_row(k, i); });
    stage_tile<T, D, kBwdThreads>(vs + (j & 1) * BN * LD, LD, BN, v,
                                  [&](int i) { return kv_row(v, i); });
    cp_async_commit();
  };
  if (ntiles > 0) {
    auto row = [&](const T* x, int r) {
      return r < R ? x + qrow(r) * D : nullptr;
    };
    stage_tile<T, D, kBwdThreads>(qs, LD, kDqRows, q,
                                  [&](int r) { return row(q, r); });
    stage_tile<T, D, kBwdThreads>(dos, LD, kDqRows, dout,
                                  [&](int r) { return row(dout, r); });
    stage_kv(0);
  }

  for (int r = threadIdx.x; r < kDqRows; r += kBwdThreads) {
    ls[r] = r < R ? lse[qrow(r)] * kLog2e : CUDART_INF_F;
    dls[r] = r < R ? delta[qrow(r)] : 0.f;
  }
  __syncthreads();
  float l2[2], dl[2];
  int qp[2];  // this thread's rows g and g + 8
  for (int hr = 0; hr < 2; ++hr) {
    const int lr = w * 16 + lane_g() + 8 * hr;
    l2[hr] = ls[lr];
    dl[hr] = dls[lr];
    qp[hr] = (r0 + lr) / G;
  }

  float acc[D / 8][4];
  zero(acc);
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      stage_kv(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q, dO) landed for every thread
    T* kt = ks + (j & 1) * BN * LD;
    T* vt = vs + (j & 1) * BN * LD;
    if constexpr (SPLIT) {
      split_tile<D, kBwdThreads>(kt, kl, LD, BN);
      split_tile<D, kBwdThreads>(vt, vl, LD, BN);
      __syncthreads();
    }
    auto ld_bt = [&](const T* x, const T* xl, int n0, int k0) {
      if constexpr (SPLIT) return F::load_bt(x, xl, LD, n0, k0);
      else return F::load_bt(x, LD, n0, k0);
    };
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    warp_product<F, NT, D / KS>(
        s, [&](int kk) { return F::load_a(qs, LD, w * 16, kk * KS); },
        [&](int kk, int n) { return ld_bt(kt, kl, n * 8, kk * KS); });
    warp_product<F, NT, D / KS>(
        dp, [&](int kk) { return F::load_a(dos, LD, w * 16, kk * KS); },
        [&](int kk, int n) { return ld_bt(vt, vl, n * 8, kk * KS); });
    const int c0 = k_lo + j * BN;
    const bool edge = c0 + BN > k_hi || (causal && c0 + BN - 1 > p_lo) ||
                      (window > 0 && p_hi - c0 >= window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -l2[e >> 1]));
        if (edge && !visible(qp[e >> 1], c0 + n * 8 + 2 * t + (e & 1), k_hi,
                             causal, window))
          p = 0.f;
        s[n][e] = p * (dp[n][e] - dl[e >> 1]);  // dS
      }
    warp_product<F, D / 8, BN / KS>(
        acc, [&](int kk) { return F::acc_a(s, kk); },
        [&](int kk, int n) {
          if constexpr (SPLIT) return F::load_b(kt, kl, LD, kk * KS, n * 8);
          else return F::load_b(kt, LD, kk * KS, n * 8);
        });
    __syncthreads();  // stage j % 2 (and the lo halves) free for reuse
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int lr = w * 16 + lane_g() + 8 * hr;
    if (lr < R) {
      T* dst = dq + qrow(lr) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(dst + n * 8, acc[n][2 * hr] * scale,
               acc[n][2 * hr + 1] * scale);
    }
  }
}

// dK and dV for key tile bx / 2 of (KV head h, batch row b), over half of
// the rows that see it: rank bx % 2 of a cluster of two.
template <typename T, int D>
__device__ __forceinline__ void dkdv_block(
    int bx, int h, int b, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
    int causal, int window, int kv_len, float scale, float scale_log2) {
  using F = Frag<T>;
  constexpr int LD = D + 8, BR = kKvRows, KS = F::KS, NT = BR / 8;
  extern __shared__ float4 smem4[];
  float* ls = reinterpret_cast<float*>(smem4);  // [2][BR] lse
  float* dls = ls + 2 * BR;                     // [2][BR] delta
  T* ks = reinterpret_cast<T*>(dls + 2 * BR);   // [64][LD]
  T* vs = ks + kKvKeys * LD;                    // [64][LD]
  T* qs = vs + kKvKeys * LD;                    // [2][BR][LD]
  T* dos = qs + 2 * BR * LD;                    // [2][BR][LD]

  const int G = Hq / Hkv;
  const int half = bx & 1;  // this block's rank in its cluster
  const int c0 = (bx >> 1) * kKvKeys;
  const int TK = min(kKvKeys, Sk - c0);         // keys of the block that exist
  const int k_end = min(c0 + kKvKeys, kv_len);  // and that are visible
  const int kg = threadIdx.x / 32 * 16, t = lane_t();  // this warp's keys
  const float inv_g = 1.f / G;
  // packed query rows that can see some key of [c0, k_end): [row_lo, row_hi)
  int row_lo = 0, row_hi = 0;
  if (k_end > c0) {
    row_lo = (causal ? c0 : 0) * G;
    row_hi = (window > 0 ? min(Sq, k_end - 1 + window) : Sq) * G;
  }
  // the rows in BR-row steps, the first half of the steps for rank 0, the
  // rest for rank 1
  const int nall = (row_hi - row_lo + BR - 1) / BR;
  const int first = half ? (nall + 1) / 2 : 0;
  const int nsteps = half ? nall - first : (nall + 1) / 2;
  row_lo += first * BR;
  auto qrow = [&](int row) {  // packed row -> row index of [B, Sq, Hq]
    return ((size_t)b * Sq + row / G) * Hq + (size_t)h * G + row % G;
  };
  auto kv_off = [&](int i) {
    return (((size_t)b * Sk + c0 + i) * Hkv + h) * D;
  };
  auto stage_rows = [&](int j) {  // rows of step j into stage j % 2
    const int p0 = row_lo + j * BR, st = j & 1;
    auto row = [&](const T* x, int i) {
      return p0 + i < row_hi ? x + qrow(p0 + i) * D : nullptr;
    };
    stage_tile<T, D, kBwdThreads>(qs + st * BR * LD, LD, BR, q,
                                  [&](int i) { return row(q, i); });
    stage_tile<T, D, kBwdThreads>(dos + st * BR * LD, LD, BR, dout,
                                  [&](int i) { return row(dout, i); });
    for (int i = threadIdx.x; i < BR; i += kBwdThreads) {  // zeros past
      const bool ok = p0 + i < row_hi;                    // row_hi
      const size_t r = ok ? qrow(p0 + i) : 0;
      cp_async4(ls + st * BR + i, lse + r, ok);
      cp_async4(dls + st * BR + i, delta + r, ok);
    }
    cp_async_commit();
  };
  if (nsteps > 0) {
    auto key = [&](const T* x, int i) {
      return c0 + i < k_end ? x + kv_off(i) : nullptr;
    };
    stage_tile<T, D, kBwdThreads>(ks, LD, kKvKeys, k,
                                  [&](int i) { return key(k, i); });
    stage_tile<T, D, kBwdThreads>(vs, LD, kKvKeys, v,
                                  [&](int i) { return key(v, i); });
    stage_rows(0);
  }

  float dka[D / 8][4], dva[D / 8][4];
  zero(dka);
  zero(dva);
  for (int j = 0; j < nsteps; ++j) {
    if (j + 1 < nsteps) {
      stage_rows(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step j's rows (and K, V) landed for every thread
    const int st = j & 1, p0 = row_lo + j * BR;
    const T* qt = qs + st * BR * LD;
    const T* dot = dos + st * BR * LD;
    float s[NT][4], dp[NT][4];  // S^T, dP^T: this warp's keys x the rows
    zero(s);
    zero(dp);
    warp_product<F, NT, D / KS>(
        s, [&](int kk) { return F::load_a(ks, LD, kg, kk * KS); },
        [&](int kk, int n) { return F::load_bt(qt, LD, n * 8, kk * KS); });
    warp_product<F, NT, D / KS>(
        dp, [&](int kk) { return F::load_a(vs, LD, kg, kk * KS); },
        [&](int kk, int n) { return F::load_bt(dot, LD, n * 8, kk * KS); });
    const int pb = p0 / G, pr = p0 - pb * G;  // p0's position, offset
    const bool edge = p0 + BR > row_hi || c0 + kKvKeys > k_end ||
                      (causal && c0 + kKvKeys - 1 > pb) ||
                      (window > 0 && (p0 + BR - 1) / G - c0 >= window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // this thread's rows 8n + 2t + c
        const int col = n * 8 + 2 * t + c;
        const float l2 = ls[st * BR + col] * kLog2e, dl = dls[st * BR + col];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // keys g and g + 8
          const int e = 2 * hr + c;
          float p = exp2f(fmaf(s[n][e], scale_log2, -l2));
          if (edge) {
            const int kp = c0 + kg + lane_g() + 8 * hr;
            if (!(p0 + col < row_hi &&
                  visible(pb + div_small(pr + col, inv_g), kp, k_end,
                          causal, window)))
              p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dl);  // dS^T
          s[n][e] = p;                     // P^T
        }
      }
    warp_product<F, D / 8, BR / KS>(
        dva, [&](int kk) { return F::acc_a(s, kk); },
        [&](int kk, int n) { return F::load_b(dot, LD, kk * KS, n * 8); });
    warp_product<F, D / 8, BR / KS>(
        dka, [&](int kk) { return F::acc_a(dp, kk); },
        [&](int kk, int n) { return F::load_b(qt, LD, kk * KS, n * 8); });
    __syncthreads();  // stage j % 2 is free for step j + 2
  }

  // rank 1's sums through the cluster's shared memory (over its K, V and
  // Q/dO tiles, free now) into rank 0's, in a fixed order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* red = reinterpret_cast<float*>(ks);  // [2][64][D]
  static_assert(2 * kKvKeys * D * 4 <= (2 * kKvKeys + 4 * BR) * LD * sizeof(T),
                "the sums fit over the tiles");
  if (half) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = (kg + lane_g() + 8 * hr) * D + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(red + i) =
            make_float2(dka[n][2 * hr], dka[n][2 * hr + 1]);
        *reinterpret_cast<float2*>(red + kKvKeys * D + i) =
            make_float2(dva[n][2 * hr], dva[n][2 * hr + 1]);
      }
  }
  cluster.sync();  // rank 1's sums are visible to rank 0
  if (!half) {
    const float* other = cluster.map_shared_rank(red, 1);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = kg + lane_g() + 8 * hr;
      if (key < TK) {
        const size_t off = kv_off(key) + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int i = key * D + n * 8 + 2 * t;
          const float2 rk = *reinterpret_cast<const float2*>(other + i);
          const float2 rv =
              *reinterpret_cast<const float2*>(other + kKvKeys * D + i);
          store2(dk + off + n * 8, (dka[n][2 * hr] + rk.x) * scale,
                 (dka[n][2 * hr + 1] + rk.y) * scale);
          store2(dv + off + n * 8, dva[n][2 * hr] + rv.x,
                 dva[n][2 * hr + 1] + rv.y);
        }
      }
    }
  }
  cluster.sync();  // rank 1's shared memory outlives rank 0's reads
}
// One launch for both kinds of block, so that the dQ blocks fill the SMs
// that the causal triangle's short dK/dV blocks leave idle: blocks x <
// n_kv of each (KV head, batch row) are dK/dV blocks (pairs of a cluster),
// the rest dQ blocks (one past the last when their count is odd, idle).
template <typename T, int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kBwdThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                 int Hq, int Hkv, int causal, int window, int kv_len,
                 float scale, float scale_log2, int n_kv, int n_q) {
  const int h = blockIdx.y, b = blockIdx.z;
  if (blockIdx.x < n_kv) {
    dkdv_block<T, D>(blockIdx.x, h, b, q, k, v, dout, lse, delta, dk, dv,
                     Sq, Sk, Hq, Hkv, causal, window, kv_len, scale,
                     scale_log2);
  } else if (blockIdx.x - n_kv < n_q) {
    dq_block<T, D>(blockIdx.x - n_kv, h, b, q, k, v, dout, lse, delta, dq,
                   Sq, Sk, Hq, Hkv, causal, window, kv_len, scale,
                   scale_log2);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int window,
                   int kv_len, cudaStream_t s) {
  using Sh = BwdShape<T, D>;
  cudaError_t err = set_smem(flash_bwd_kernel<T, D>, Sh::SMEM);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv, rows = B * Sq * Hq;
  const double sc = 1.0 / std::sqrt(static_cast<double>(D));
  const float scale = static_cast<float>(sc);
  const float scale_log2 = static_cast<float>(sc) * kLog2e;
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_delta_kernel<T, D><<<(rows * 8 + 255) / 256, 256, 0, s>>>(
      static_cast<const T*>(o), dot, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kv = 2 * ((Sk + kKvKeys - 1) / kKvKeys);
  const int n_q = (Sq * G + kDqRows - 1) / kDqRows;
  const dim3 grid(n_kv + (n_q + 1) / 2 * 2, Hkv, B);
  flash_bwd_kernel<T, D><<<grid, kBwdThreads, Sh::SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dot, lse, delta, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq, Hkv, causal,
      window, kv_len, scale, scale_log2, n_kv, n_q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B,
                     int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                     int kv_len, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                           Sk, Hq, Hkv, causal, window, kv_len, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                           Sk, Hq, Hkv, causal, window, kv_len, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                            Sk, Hq, Hkv, causal, window, kv_len, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q, o, dout, dq [B, Sq, Hq, D]; k, v, dk, dv [B, Sk, Hkv, D], all of one
// dtype (0 = f32, 1 = bf16), contiguous, on 16-byte boundaries, D in {32,
// 64, 128}; lse and delta f32 [B, Sq, Hq]: lse from the forward kernel's
// launch with the same mask, delta a scratch this call fills.  The mask
// arguments are the forward's (repro_flash_attention).  Runs two kernels
// on `stream` (dQ and delta, then dK and dV) and returns the first launch
// error.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
    int window, int kv_len, int dtype, void* stream) {
  using namespace repro;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      window < 0 || kv_len < 1 || kv_len > Sk ||
      ((causal || window > 0) && Sq != Sk))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return launch_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk,
                           Hq, Hkv, causal, window, kv_len, s);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B,
                                   Sq, Sk, Hq, Hkv, causal, window, kv_len,
                                   s);
  return cudaErrorInvalidValue;
}
