// Dense GQA prefill attention for Hopper (sm_90a): every query position of
// a right-padded prompt batch against the same batch's keys (Sq == Sk, with
// causal, sliding-window or full masks), or, in full mode, Sq queries
// against Sk keys of another sequence (the encoder-decoder family's cross
// attention) with a key bound: keys at or past kv_len are masked, as the
// TPU kernel masks keys past its seq_k when K is cut to kv_len.
//
// Replaces the TPU kernel `flash_attention_kernel` (body `_kernel`) in
// src/repro/kernels/flash_attention/kernel.py.
//
// What bounds it: at the decoder-only serving shapes (S up to a few
// hundred, D = 128) the least time is set by the bytes (q, k, v read
// once, out written once); the causal triangle's products are ~1/5 of
// that time at the bf16 tensor core rate.  A full-mode encoder over 1,536
// frames (whisper's) is bound by its operations instead.  What both
// kernels below keep from the TPU kernel is the work it skips: the K/V
// loop of a block starts at the sliding window's edge and stops at the
// causal frontier of its last query row, or at the key bound, so bytes and
// operations follow the unmasked region (the TPU grid stepped over every
// KV block and skipped the dead ones with pl.when).  Keys at or past the
// key bound kv_len (<= Sk; the ragged last tile, as Sk need not be a
// multiple of the tile) are masked and never read: the f32 kernel stages
// zeros for them (cp.async zero fill) and the tensor maps end at kv_len,
// so TMA fills them with zeros, and whatever the rows from kv_len to Sk
// hold cannot reach the output.  Query rows past Sq are neither computed
// nor written.  Rows are packed as the TPU kernel packs them: row r of the
// Sq * G rows of a KV head is position r / G, query head h * G + r % G, so
// the G query heads of one KV head share each K/V tile.
//
// bf16 (the serves): `flash_tc_kernel`, on the tensor cores.  One block
// per (batch row, KV head, 64 packed query rows): one consumer warpgroup
// and one producer warp.  The producer's lane 0 brings 64-key K and V
// tiles by TMA (4-D tensor maps over the first kv_len keys of [B, Sk, Hkv,
// D], 128-byte swizzle, or 64-byte at D = 32) into a 2-stage ring with
// full / empty mbarriers; TMA's out-of-bounds zero fill covers the keys
// of the last tile at or past kv_len.  The
// consumers compute S = Q.K^T by wgmma m64n64k16 (Q and K from shared
// memory, f32 accumulators in registers), run the online softmax in
// registers (a row's max and sum reduced by shuffles over the 4 lanes
// that hold it; masks as -inf scores, built only on the diagonal,
// window-edge and ragged tiles), convert P to bf16 in registers as the A
// operand of O += P.V (wgmma m64nDk16, V the MN-major B operand from
// shared memory), and write O from registers to device memory once.
// That consumer step is attention_tc.cuh's, shared with the paged prefix
// prefill kernel.  Head sizes 32, 64 and 128.
//
// f32 (training, the f32 engines): `flash_mma_kernel`, on the tensor
// cores in 3xTF32 (flash_mma.cuh's warp tile step: mma.sync m16n8k8, each
// operand split hi + lo, lo.lo dropped), which keeps the 2e-4 hold
// against the plain f32 version that one TF32 product (~1e-3) misses;
// its two long sums (S over D, O over the keys) add each k step's hi.hi
// product with an f32 add (warp_product_rn), as the tensor cores'
// accumulation drifts one way over long chains and the softmax
// amplifies what S carries (whisper's scores of several hundred).
// One block per (batch row, KV head, 64 packed query rows), 4 warps of
// 16 rows; Q staged once, 32-key K/V tiles by cp.async into a two-stage
// ring, keys past k_hi staged as zeros; S, the online softmax and O stay
// in registers, P feeding O += P.V as the A operand with no trip through
// shared memory.  Head sizes 32, 64 and 128.
//
// Both write each query row's log-sum-exp of its scaled scores (lse [B,
// Sq, Hq], natural log, +inf for a row with no visible key) when given a
// pointer: the backward kernel (flash_attention_bwd.cu) recomputes the
// probabilities from it.  A null lse pointer skips that store, so the
// serving launches are unchanged.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <cmath>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "flash_mma.cuh"
#include "hopper_mma.cuh"

namespace repro {
namespace {

constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// f32 on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps of 16 packed query rows
constexpr int kMmaRows = 64;      // packed query rows a block
constexpr int kMmaKeys = 32;      // keys a staged K/V tile

template <int D>
struct MmaShape {
  static constexpr int LDQ = D + 8;  // Q, K rows (read along k): 8 mod 32
  static constexpr int LDV = D + 4;  // V rows (read down a column): 4 mod 32
  static constexpr int SMEM =
      sizeof(float) * (kMmaRows * LDQ + 2 * kMmaKeys * (LDQ + LDV));
};

// One block per (batch row, KV head, 64 packed query rows); warp w owns
// rows 16w .. 16w + 15.  Q is staged once, K and V tiles of 32 keys by
// cp.async into a two-stage ring (tile j + 1 in flight while tile j is
// used).  Per tile: S = Q.K^T (f32 accumulators), the online softmax in
// registers (the flash_tc_kernel step), then O += P.V with P the A
// operand straight from S's registers.  lse (optional) receives each
// row's log-sum-exp in natural units, +inf for a row with no visible key.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 int causal, int window, int kv_len, float scale_log2) {
  using F = Frag<float>;
  using Sh = MmaShape<D>;
  constexpr int BN = kMmaKeys, LDQ = Sh::LDQ, LDV = Sh::LDV, NT = BN / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][LDQ]
  float* ks = qs + kMmaRows * LDQ;              // [2][BN][LDQ]
  float* vs = ks + 2 * BN * LDQ;                // [2][BN][LDV]

  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.x * kMmaRows;
  const int R = min(kMmaRows, Sq * G - r0);
  const int w = threadIdx.x / 32, t = lane_t();
  // keys any row of this tile can see: [k_lo, k_hi)
  const int p_lo = r0 / G, p_hi = (r0 + R - 1) / G;
  const int k_hi = causal ? min(kv_len, p_hi + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;
  auto qrow = [&](int r) {  // packed row r -> row index of [B, Sq, Hq]
    const int row = r0 + r;
    return ((size_t)b * Sq + row / G) * Hq + (size_t)h * G + row % G;
  };
  auto stage_kv = [&](int j) {  // tile j into stage j % 2; keys past
    const int c0 = k_lo + j * BN;  // k_hi are zeros
    auto kv_row = [&](const float* x, int i) {
      return c0 + i < k_hi ? x + (((size_t)b * Sk + c0 + i) * Hkv + h) * D
                           : nullptr;
    };
    stage_tile<float, D, kMmaThreads>(
        ks + (j & 1) * BN * LDQ, LDQ, BN, k,
        [&](int i) { return kv_row(k, i); });
    stage_tile<float, D, kMmaThreads>(
        vs + (j & 1) * BN * LDV, LDV, BN, v,
        [&](int i) { return kv_row(v, i); });
    cp_async_commit();
  };
  if (ntiles > 0) {
    stage_tile<float, D, kMmaThreads>(
        qs, LDQ, kMmaRows, q,
        [&](int r) { return r < R ? q + qrow(r) * D : nullptr; });
    stage_kv(0);
  }

  int qp[2];  // query positions of this thread's rows g and g + 8
  for (int hr = 0; hr < 2; ++hr) qp[hr] = (r0 + w * 16 + lane_g() + 8 * hr) / G;
  float o[D / 8][4], o_lo[D / 8][4];  // O = o + o_lo (warp_product_rn)
  zero(o);
  zero(o_lo);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      stage_kv(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread
    const float* kt = ks + (j & 1) * BN * LDQ;
    const float* vt = vs + (j & 1) * BN * LDV;
    float s[NT][4], s_lo[NT][4];
    zero(s);
    zero(s_lo);
    warp_product_rn<NT, D / 8>(
        s, s_lo, [&](int kk) { return F::load_a(qs, LDQ, w * 16, kk * 8); },
        [&](int kk, int n) { return F::load_bt(kt, LDQ, n * 8, kk * 8); });
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s_lo[n][e];
    // masks, only where some key of the tile is hidden from some row
    const int c0 = k_lo + j * BN;
    if (c0 + BN > k_hi || (causal && c0 + BN - 1 > p_lo) ||
        (window > 0 && p_hi - c0 >= window)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = c0 + n * 8 + 2 * t + (e & 1), p = qp[e >> 1];
          if (!(kp < k_hi && (!causal || kp <= p) &&
                (window <= 0 || p - kp < window)))
            s[n][e] = -CUDART_INF_F;
        }
    }
    // online softmax in registers (raw scores, scaled in the exponent)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hr], mx);
      const float mu = mn == -CUDART_INF_F ? 0.f : mn * scale_log2;
      const float alpha = exp2f(m[hr] * scale_log2 - mu);  // 0 at -inf
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = exp2f(fmaf(x, scale_log2, -mu));
          sum += x;
        }
      l[hr] = fmaf(l[hr], alpha, sum);  // this thread's share of the row
      m[hr] = mn;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * hr] *= alpha;
        o[n][2 * hr + 1] *= alpha;
        o_lo[n][2 * hr] *= alpha;
        o_lo[n][2 * hr + 1] *= alpha;
      }
    }
    warp_product_rn<D / 8, NT>(
        o, o_lo, [&](int kk) { return F::acc_a(s, kk); },
        [&](int kk, int n) { return F::load_b(vt, LDV, kk * 8, n * 8); });
    __syncthreads();  // stage j % 2 is free for tile j + 2
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int lr = w * 16 + lane_g() + 8 * hr;
    if (lr < R) {
      const size_t row = qrow(lr);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(out + row * D + n * 8 + 2 * t,
               (o[n][2 * hr] + o_lo[n][2 * hr]) * inv,
               (o[n][2 * hr + 1] + o_lo[n][2 * hr + 1]) * inv);
      if (lse != nullptr && t == 0)
        lse[row] = sum > 0.f ? fmaf(m[hr], scale_log2, log2f(sum)) * kLn2
                             : CUDART_INF_F;
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Sq, int Sk, int Hq,
                       int Hkv, int causal, int window, int kv_len,
                       cudaStream_t stream) {
  const size_t smem = MmaShape<D>::SMEM;
  cudaError_t err = set_smem(flash_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const dim3 grid((Sq * G + kMmaRows - 1) / kMmaRows, Hkv, B);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk,
      Hq, Hkv, causal, window, kv_len,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))) * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Sq, int Sk, int Hq,
                       int Hkv, int D, int causal, int window, int kv_len,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_mma<32>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                            window, kv_len, stream);
    case 64:
      return launch_mma<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                            window, kv_len, stream);
    case 128:
      return launch_mma<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                             window, kv_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcStages = 2;                // K/V ring depth
constexpr int kTcThreads = 128 + 32;        // consumer warpgroup + producer

template <int D>
struct TcShape : TcTile<D> {  // Q, then the K and V rings, then barriers
  static constexpr int SMEM =
      1024 + TcTile<D>::BYTES * (1 + 2 * kTcStages) + 2 * kTcStages * 8;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const __grid_constant__ CUtensorMap tmap_k,
                const __grid_constant__ CUtensorMap tmap_v,
                const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Hq, int Hkv, int causal, int window, int kv_len,
                float scale_log2) {
  using Sh = TcShape<D>;
  constexpr int RB = Sh::RB, BN = kTcKeys, NS = kTcStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;                  // [REGIONS][64][RB]
  unsigned char* ks = qs + Sh::BYTES;        // [NS][REGIONS][BN][RB]
  unsigned char* vs = ks + NS * Sh::BYTES;   // [NS][REGIONS][BN][RB]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + NS * Sh::BYTES);
  uint64_t* empty = full + NS;

  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.x * kTcRows;
  const int R = min(kTcRows, Sq * G - r0);
  // keys any row of this tile can see: [k_lo, k_hi)
  const int p_lo = r0 / G, p_hi = (r0 + R - 1) / G;
  const int k_hi = causal ? min(kv_len, p_hi + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int ntiles = (k_hi - k_lo + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: lane 0 issues the TMA loads
    if (threadIdx.x == 128) {
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(&empty[s], ((j / NS) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * Sh::BYTES);
        for (int kr = 0; kr < Sh::REGIONS; ++kr) {
          const int off = s * Sh::BYTES + kr * BN * RB;
          tma_load_4d(ks + off, &tmap_k, &full[s], kr * (RB / 2), h,
                      k_lo + j * BN, b);
          tma_load_4d(vs + off, &tmap_v, &full[s], kr * (RB / 2), h,
                      k_lo + j * BN, b);
        }
      }
    }
    return;
  }

  // consumers: the Q tile into shared memory by cp.async, all of it in
  // flight at once, in the swizzled layout that TMA would give it (rows
  // past the last are zero-filled)
  const int tid = threadIdx.x;
  auto qoff = [&](int r) {  // element offset of packed row r in q / out
    return (((size_t)b * Sq + r / G) * Hq + (size_t)h * G + r % G) * D;
  };
  constexpr int CPRow = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < kTcRows * CPRow; e += 128) {
    const int row = e / CPRow, cc = e % CPRow;
    const bool ok = row < R;
    cp_async16(qs + tc_chunk<D>(row, cc),
               q + (ok ? qoff(r0 + row) + cc * 8 : 0), ok);
  }
  cp_async_wait_all();
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  int qp[2];  // query positions of this thread's two rows
  for (int hr = 0; hr < 2; ++hr) qp[hr] = (r0 + tc_row(hr)) / G;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    __syncwarp();  // the warp converges before the .aligned wgmma
    // masks, only where some key of the tile is hidden from some row
    const int c0 = k_lo + j * BN;
    const bool edge = c0 + BN > k_hi || (causal && c0 + BN - 1 > p_lo) ||
                      (window > 0 && p_hi - c0 >= window);
    tc_attend_tile<D>(
        qs, ks + s * Sh::BYTES, vs + s * Sh::BYTES, edge,
        [&](int col, int hr) {
          const int kp = c0 + col, p = qp[hr];
          return !(kp < k_hi && (!causal || kp <= p) &&
                   (window <= 0 || p - kp < window));
        },
        scale_log2, o, m, l);
    mbar_arrive(&empty[s]);  // this thread is done with stage s
  }
  tc_store<D>(o, l, R, [&](int lr) { return out + qoff(r0 + lr); });
  if (lse != nullptr) {  // m + log(l) in natural units, +inf for no key
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = l[hr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int lr = tc_row(hr);
      if ((tid & 3) == 0 && lr < R)
        lse[qoff(r0 + lr) / D] =
            sum > 0.f ? fmaf(m[hr], scale_log2, log2f(sum)) * kLn2
                      : CUDART_INF_F;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over x [B, Sk, Hkv, D] whose box is one region (RB bytes of
// D) of 64 consecutive keys of one (row, KV head).  The map's key extent
// is kv_len (<= Sk) over the rows' Sk stride, so a box reaching past
// kv_len is zero-filled there.
template <int D>
bool kv_map(CUtensorMap* map, const void* x, int B, int Sk, int Hkv,
            int kv_len) {
  using Sh = TcShape<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                              (cuuint64_t)kv_len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Sk * Hkv * D * 2};
  const cuuint32_t box[4] = {Sh::RB / 2, 1, kTcKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Sh::SWIZZLE == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      void* out, float* lse, int B, int Sq, int Sk, int Hq,
                      int Hkv, int causal, int window, int kv_len,
                      cudaStream_t stream) {
  CUtensorMap mk, mv;
  if (!kv_map<D>(&mk, k, B, Sk, Hkv, kv_len) ||
      !kv_map<D>(&mv, v, B, Sk, Hkv, kv_len))
    return cudaErrorInvalidValue;
  const size_t smem = TcShape<D>::SMEM;
  cudaError_t err = set_smem(flash_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const dim3 grid((Sq * G + kTcRows - 1) / kTcRows, Hkv, B);
  flash_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), lse, Sq, Hq, Hkv, causal, window,
      kv_len,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))) * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int Sq, int Sk, int Hq,
                        int Hkv, int D, int causal, int window, int kv_len,
                        cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_tc<32>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                           window, kv_len, stream);
    case 64:
      return launch_tc<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                           window, kv_len, stream);
    case 128:
      return launch_tc<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                            window, kv_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q, out [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D].  All contiguous, of one
// dtype (0 = f32, 1 = bf16), on 16-byte boundaries (cp.async, TMA), with
// D in {32, 64, 128}.  causal: 0 or 1; window: 0 for none, else a query
// at position p sees keys k with p - k < window; query i sits at position
// i, so a causal or window mask needs Sq == Sk.  Keys at or past kv_len
// (1 <= kv_len <= Sk) are masked and not read.  lse: null, or f32 [B, Sq,
// Hq] that receives each query row's log-sum-exp of its scaled scores
// (natural log; +inf for a row with no visible key).  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int Sq, int Sk, int Hq, int Hkv,
                                     int D, int causal, int window,
                                     int kv_len, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      window < 0 || kv_len < 1 || kv_len > Sk ||
      ((causal || window > 0) && Sq != Sk))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == repro::kFloat32)
    return repro::launch_f32(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, D, causal,
                             window, kv_len, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_bf16(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, D, causal,
                              window, kv_len, s);
  return cudaErrorInvalidValue;
}
