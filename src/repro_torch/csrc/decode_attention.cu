// Dense decode attention for Hopper (sm_90a): one query token per request
// against its own contiguous KV cache [B, S, Hkv, D], masked at
// lengths[b] (the padded batch's waiting slots and the unwritten tail).
// One source, two caches: K/V in the query's type, or int8 with one bf16
// scale per (token, head).
//
// Replaces the TPU kernels `decode_attention_kernel` (body `_kernel`) and
// `decode_attention_int8_kernel` (body `_kernel_i8`) in
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
// The int8 cache moves half the bf16 cache's bytes (one byte a value, plus
// a 2-byte scale per D values), so its bytes bound is half the bf16
// kernel's.  Each value is dequantised in f32 as it is staged, value *
// scale, just before the products, as the TPU kernel does; the scales are
// read in place as the model's cache stores them, in bf16 (the TPU
// wrapper's f32 copy of them is a pass the card does not need).  A scale
// past the length is never read, so NaN or inf there cannot matter.
//
// Simple first: scalar loads, f32 FMAs, no tensor cores and no split over
// the KV axis; B * Hkv blocks fill the card only at large batch.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"

namespace repro {
namespace {

constexpr int kDecodeTileKeys = 32;  // cache rows staged per step

// Stage cache rows c0 .. c0 + TK of (request b, KV head h) into smem rows
// [TK][ld] as f32; an int8 row is multiplied by its bf16 scale.  Rows at
// or past `len` are written as zeros, and neither they nor their scales
// are read.
template <typename KV>
__device__ __forceinline__ void stage_kv(float* dst, int ld,
                                         const KV* __restrict__ src,
                                         const __nv_bfloat16* __restrict__ sc,
                                         int b, int h, int c0, int len, int S,
                                         int Hkv, int D) {
  for (int e = threadIdx.x; e < kDecodeTileKeys * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    float val = 0.f;
    if (c0 + t < len) {
      const size_t r = ((size_t)b * S + c0 + t) * Hkv + h;  // (b, slot, h)
      val = to_f32(src[r * D + d]);
      if constexpr (std::is_same<KV, int8_t>::value)
        val *= __bfloat162float(sc[r]);
    }
    dst[t * ld + d] = val;
  }
}

// T: the query's and output's type; KV: the cache's (T, or int8 with
// bf16 scales k_scale / v_scale [B, S, Hkv]; null for a T cache).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_cache,
              const KV* __restrict__ v_cache,
              const __nv_bfloat16* __restrict__ k_scale,
              const __nv_bfloat16* __restrict__ v_scale,
              const int* __restrict__ lengths, T* __restrict__ out, int S,
              int Hq, int Hkv, int D, float scale) {
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
    stage_kv(ks, ld, k_cache, k_scale, b, h, c0, len, S, Hkv, D);
    stage_kv(vs, ld, v_cache, v_scale, b, h, c0, len, S, Hkv, D);
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

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* k_scale, const void* v_scale,
                   const void* lengths, void* out, int B, int S, int Hq,
                   int Hkv, int D, cudaStream_t stream) {
  constexpr int TK = kDecodeTileKeys;
  const int G = Hq / Hkv, ld = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)G * ld + 2 * (size_t)TK * ld + G * TK +
                       (size_t)G * D + 3 * G);
  cudaError_t err = set_smem(decode_kernel<T, KV>, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, KV><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_cache),
      static_cast<const KV*>(v_cache),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, Hq, Hkv, D,
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
    return repro::launch<float, float>(q, k_cache, v_cache, nullptr,
                                       nullptr, lengths, out, B, S, Hq, Hkv,
                                       D, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, v_cache, nullptr, nullptr, lengths, out, B, S, Hq, Hkv,
        D, s);
  return cudaErrorInvalidValue;
}

// As repro_decode_attention, with an int8 cache: k_cache, v_cache int8
// [B, S, Hkv, D] and k_scale, v_scale bf16 [B, S, Hkv] (slices of the
// model's int8 cache); q and out of `dtype` (0 = f32, 1 = bf16).
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths,
    void* out, int B, int S, int Hq, int Hkv, int D, int dtype,
    void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float, int8_t>(q, k_cache, v_cache, k_scale,
                                        v_scale, lengths, out, B, S, Hq,
                                        Hkv, D, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, int8_t>(
        q, k_cache, v_cache, k_scale, v_scale, lengths, out, B, S, Hq, Hkv,
        D, s);
  return cudaErrorInvalidValue;
}
