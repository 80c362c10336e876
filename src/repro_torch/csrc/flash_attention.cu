// Dense GQA prefill attention for Hopper (sm_90a): every query position of
// a right-padded prompt batch against the same batch's keys, Sq == Sk = S,
// with causal, sliding-window or full masks.
//
// Replaces the TPU kernel `flash_attention_kernel` (body `_kernel`) in
// src/repro/kernels/flash_attention/kernel.py.
//
// What bounds it: at the serving shapes (S up to a few hundred, D = 128)
// the least time is set by the bytes (q, k, v read once, out written once);
// the causal triangle's products are ~1/5 of that time at the bf16 tensor
// core rate.  This first version computes in f32 on the CUDA cores out of
// shared memory, so it is bound by shared-memory loads, not by either
// floor.  What the design keeps from the TPU kernel is the work it skips:
// the K/V loop of a block starts at the sliding window's edge and stops at
// the causal frontier of its last query row, so bytes and operations
// follow the unmasked region (the TPU grid stepped over every KV block and
// skipped the dead ones with pl.when).  Keys at or past S (the ragged last
// tile; S need not be a multiple of the tile) are staged as zeros and
// masked, and query rows past S are neither computed nor written.
//
// One block per (batch row, KV head, tile of TR query rows of the S * G
// rows); row r is position r / G, query head h * G + r % G, so the G query
// heads of one KV head share each staged K/V tile.  Softmax is online in
// f32 (running max, sum and [TR, D] accumulator in shared memory); q is
// scaled by D**-0.5 in f32 before the dot.  Simple first: scalar loads,
// f32 FMAs, no tensor cores.
#include <cmath>

#include "attention_common.cuh"

namespace repro {
namespace {

constexpr int kFlashThreads = 256;
constexpr int kTileRows = 64;  // TR: query rows per block
constexpr int kTileKeys = 32;  // TK: keys staged per step

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Hq,
             int Hkv, int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, ld = D + 1;
  const int r0 = blockIdx.x * kTileRows;
  const int R = min(kTileRows, S * G - r0);
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
    return (((size_t)b * S + row / G) * Hq + (size_t)h * G + row % G) * D;
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
  const int k_hi = causal ? min(S, p_hi + 1) : S;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  for (int c0 = k_lo; c0 < k_hi; c0 += kTileKeys) {
    __syncthreads();  // the previous tile is consumed
    auto row_off = [&](int t) {
      return (((size_t)b * S + c0 + t) * Hkv + h) * D;
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
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hq, int Hkv, int D, int causal,
                   int window, cudaStream_t stream) {
  const int G = Hq / Hkv, ld = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)kTileRows * ld + 2 * (size_t)kTileKeys * ld +
                       kTileRows * kTileKeys + (size_t)kTileRows * D +
                       3 * kTileRows);
  cudaError_t err = set_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S * G + kTileRows - 1) / kTileRows, Hkv, B);
  flash_kernel<T><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, D, causal,
      window, static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q, out [B, S, Hq, D]; k, v [B, S, Hkv, D].  All contiguous, of one dtype
// (0 = f32, 1 = bf16).  causal: 0 or 1; window: 0 for none, else a query
// at position p sees keys k with p - k < window.  Launches on `stream` and
// returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int Hq, int Hkv, int D, int causal,
                                     int window, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (B < 0 || S < 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, out, B, S, Hq, Hkv, D, causal,
                                window, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D,
                                        causal, window, s);
  return cudaErrorInvalidValue;
}
