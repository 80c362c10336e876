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
// zeros for them and the tensor maps end at kv_len, so TMA fills them with
// zeros, and whatever the rows from kv_len to Sk hold cannot reach the
// output.  Query rows past Sq are neither computed nor written.  Rows are
// packed as the TPU kernel packs them: row r of the Sq * G rows of a KV
// head is position r / G, query head h * G + r % G, so the G query heads
// of one KV head share each K/V tile.
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
// f32: `flash_kernel`, the scalar kernel of the first port.  Its callers
// hold it to 2e-4 of the plain f32 version, which needs true f32 products;
// TF32 tensor cores would give ~1e-3.  It computes in f32 on the CUDA cores
// out of shared memory (one block per (row, KV head, 64 query rows),
// running max, sum and [64, D] accumulator in shared memory), so it is
// bound by shared-memory loads, not by either floor.  For training it also
// writes each query row's log-sum-exp of its scaled scores (lse [B, Sq,
// Hq], natural log), which the backward kernel (flash_attention_bwd.cu)
// reads to recompute the probabilities; a null lse pointer skips that
// store, so the serving launches are unchanged.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <cmath>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "hopper_mma.cuh"

namespace repro {
namespace {

constexpr int kFlashThreads = 256;
constexpr int kTileRows = 64;  // TR: query rows per block
constexpr int kTileKeys = 32;  // TK: keys staged per step

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int D,
             int causal, int window, int kv_len, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, ld = D + 1;
  const int r0 = blockIdx.x * kTileRows;
  const int R = min(kTileRows, Sq * G - r0);
  float* qs = smem;                    // [TR][ld]  scaled queries
  float* ks = qs + kTileRows * ld;     // [TK][ld]  staged K tile
  float* vs = ks + kTileKeys * ld;     // [TK][ld]  staged V tile
  float* sc = vs + kTileKeys * ld;     // [TR][TK]  scores, then probabilities
  float* acc = sc + kTileRows * kTileKeys;  // [TR][D] f32 accumulator
  float* m = acc + kTileRows * D;      // [TR]      running max
  float* l = m + kTileRows;            // [TR]      running sum
  float* alpha = l + kTileRows;        // [TR]      per-step rescale

  // element offset of query row r (position, query head) in q / out
  auto qoff = [&](int r) {
    const int row = r0 + r;
    return (((size_t)b * Sq + row / G) * Hq + (size_t)h * G + row % G) * D;
  };
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    qs[r * ld + d] = to_f32(q[qoff(r) + d]) * scale;
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }

  // keys any row of this tile can see: [k_lo, k_hi)
  const int p_lo = r0 / G, p_hi = (r0 + R - 1) / G;
  const int k_hi = causal ? min(kv_len, p_hi + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  for (int c0 = k_lo; c0 < k_hi; c0 += kTileKeys) {
    __syncthreads();  // the previous tile is consumed
    auto row_off = [&](int t) {
      return (((size_t)b * Sk + c0 + t) * Hkv + h) * D;
    };
    auto ok = [&](int t) { return c0 + t < k_hi; };
    stage_rows(ks, ld, k, kTileKeys, D, row_off, ok);
    stage_rows(vs, ld, v, kTileKeys, D, row_off, ok);
    __syncthreads();
    tile_scores(sc, qs, ks, ld, R, kTileKeys, D, [&](int r, int t) {
      const int kp = c0 + t, qp = (r0 + r) / G;
      return kp < k_hi && (!causal || kp <= qp) &&
             (window <= 0 || qp - kp < window);
    });
    __syncthreads();
    softmax_step(sc, R, kTileKeys, m, l, alpha);
    __syncthreads();
    tile_pv(acc, sc, vs, alpha, ld, R, kTileKeys, D);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    out[qoff(r) + d] = from_f32<T>(acc[e] / fmaxf(l[r], 1e-30f));
  }
  if (lse != nullptr) {  // a row with no visible key gets +inf: P = 0
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      lse[qoff(r) / D] = l[r] > 0.f ? m[r] + logf(l[r]) : CUDART_INF_F;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                   int causal, int window, int kv_len, cudaStream_t stream) {
  const int G = Hq / Hkv, ld = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)kTileRows * ld + 2 * (size_t)kTileKeys * ld +
                       kTileRows * kTileKeys + (size_t)kTileRows * D +
                       3 * kTileRows);
  cudaError_t err = set_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq * G + kTileRows - 1) / kTileRows, Hkv, B);
  flash_kernel<T><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, Hq, Hkv,
      D, causal, window, kv_len,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
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
                __nv_bfloat16* __restrict__ out, int Sq, int Hq, int Hkv,
                int causal, int window, int kv_len, float scale_log2) {
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
                      void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                      int causal, int window, int kv_len,
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
      static_cast<__nv_bfloat16*>(out), Sq, Hq, Hkv, causal, window, kv_len,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))) * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                        int D, int causal, int window, int kv_len,
                        cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_tc<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                           kv_len, stream);
    case 64:
      return launch_tc<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                           kv_len, stream);
    case 128:
      return launch_tc<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                            kv_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q, out [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D].  All contiguous, of one
// dtype (0 = f32, 1 = bf16); bf16 takes D in {32, 64, 128} and k, v on
// 16-byte boundaries (TMA).  causal: 0 or 1; window: 0 for none, else a
// query at position p sees keys k with p - k < window; query i sits at
// position i, so a causal or window mask needs Sq == Sk.  Keys at or past
// kv_len (1 <= kv_len <= Sk) are masked and not read.  lse: null, or
// (f32 only) f32 [B, Sq, Hq] that receives each query row's log-sum-exp.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int Sq, int Sk, int Hq, int Hkv,
                                     int D, int causal, int window,
                                     int kv_len, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      window < 0 || kv_len < 1 || kv_len > Sk ||
      ((causal || window > 0) && Sq != Sk) ||
      (lse != nullptr && dtype != repro::kFloat32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, out, static_cast<float*>(lse), B, Sq,
                                Sk, Hq, Hkv, D, causal, window, kv_len, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_bf16(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                              window, kv_len, s);
  return cudaErrorInvalidValue;
}
