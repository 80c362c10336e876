// Dense decode attention for Hopper (sm_90a): one query token per request
// against its own contiguous KV cache [B, S, Hkv, D], masked at
// lengths[b] (the padded batch's waiting slots and the unwritten tail).
//
// Replaces the TPU kernel `decode_attention_kernel` (body `_kernel`) in
// src/repro/kernels/decode_attention/kernel.py.
//
// What bounds it: bytes.  Each request's valid K/V (lengths[b] rows of
// Hkv * D values, twice) is read once and every value feeds G = Hq / Hkv
// multiply-adds per score and per output, far below the ~295 operations
// per byte the card needs before arithmetic matters.  One block per
// (request, KV head) walks tiles of its cache rows only up to lengths[b]:
// slots at or past the length are never read, so the bytes follow the real
// context and not the padded cache (the TPU grid stepped over every KV
// block and skipped the dead ones with pl.when).  A ragged last tile stages
// its masked rows as zeros and their scores are -inf, so NaN in a waiting
// slot cannot reach the output.  The G query heads of the KV head share
// each staged tile.  Softmax is online in f32; q is scaled by D**-0.5 in
// f32 before the dot.
//
// Simple first: scalar loads, f32 FMAs, no tensor cores and no split over
// the KV axis; B * Hkv blocks fill the card only at large batch.
#include <cmath>

#include "attention_common.cuh"

namespace repro {
namespace {

constexpr int kDecodeTileKeys = 32;  // cache rows staged per step

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const int* __restrict__ lengths,
              T* __restrict__ out, int S, int Hq, int Hkv, int D,
              float scale) {
  extern __shared__ float smem[];
  constexpr int TK = kDecodeTileKeys;
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv, ld = D + 1;
  float* qs = smem;              // [G][ld]   scaled queries
  float* ks = qs + G * ld;       // [TK][ld]  staged K rows
  float* vs = ks + TK * ld;      // [TK][ld]  staged V rows
  float* sc = vs + TK * ld;      // [G][TK]   scores, then probabilities
  float* acc = sc + G * TK;      // [G][D]    f32 accumulator
  float* m = acc + G * D;        // [G]       running max
  float* l = m + G;              // [G]       running sum
  float* alpha = l + G;          // [G]       per-step rescale

  const int len = min(max(lengths[b], 0), S);
  const T* qrow = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    qs[g * ld + d] = to_f32(qrow[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
  }
  for (int c0 = 0; c0 < len; c0 += TK) {
    __syncthreads();  // the previous tile is consumed
    auto row_off = [&](int t) {
      return (((size_t)b * S + c0 + t) * Hkv + h) * D;
    };
    auto ok = [&](int t) { return c0 + t < len; };
    stage_rows(ks, ld, k_cache, TK, D, row_off, ok);
    stage_rows(vs, ld, v_cache, TK, D, row_off, ok);
    __syncthreads();
    tile_scores(sc, qs, ks, ld, G, TK, D,
                [&](int, int t) { return c0 + t < len; });
    __syncthreads();
    softmax_step(sc, G, TK, m, l, alpha);
    __syncthreads();
    tile_pv(acc, sc, vs, alpha, ld, G, TK, D);
  }
  __syncthreads();
  T* orow = out + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    orow[e] = from_f32<T>(acc[e] / fmaxf(l[e / D], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* lengths, void* out, int B, int S, int Hq,
                   int Hkv, int D, cudaStream_t stream) {
  constexpr int TK = kDecodeTileKeys;
  const int G = Hq / Hkv, ld = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)G * ld + 2 * (size_t)TK * ld + G * TK +
                       (size_t)G * D + 3 * G);
  cudaError_t err = set_smem(decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(lengths),
      static_cast<T*>(out), S, Hq, Hkv, D,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, Hq, D]; k_cache, v_cache [B, S, Hkv, D] (one layer of the model's
// [L, B, S, Hkv, D] cache: a contiguous slice, not a copy); lengths [B]
// int32; out [B, Hq, D].  All contiguous, q / caches / out of one dtype
// (0 = f32, 1 = bf16).  Launches on `stream` and returns cudaGetLastError()
// after the launch.
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* lengths, void* out, int B,
                                      int S, int Hq, int Hkv, int D,
                                      int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k_cache, v_cache, lengths, out, B, S, Hq,
                                Hkv, D, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, out,
                                        B, S, Hq, Hkv, D, s);
  return cudaErrorInvalidValue;
}
