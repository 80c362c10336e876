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
// What bounds it: bytes (each request's valid K/V, lengths[b] rows of
// Hkv * D values twice, read once; G = Hq / Hkv multiply-adds a value).
// The design is decode_split.cuh's split-KV streaming kernel, with token
// t of request b at row b * S + t.  int8 moves half the bf16 cache's bytes
// (one byte a value, plus a 2-byte scale per D values); rows at or past
// the length, and their scales, are never read, so NaN, inf or int8
// extremes there cannot reach the output.
#include "decode_split.cuh"

namespace repro {
namespace {

// A contiguous cache [B, S, Hkv, D]: token t of request b is slot b * S + t.
struct DenseRows {
  static constexpr bool kGather = false;
  int S;
  __device__ int capacity() const { return S; }
  __device__ size_t slot(int b, int t, int) const {
    return (size_t)b * S + t;
  }
};

template <typename T, typename KV>
int launch_dense(const SplitArgs& a, int S, int D, cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  if (bad_split_args(a, S)) return cudaErrorInvalidValue;
  return launch_split_any<T, KV>(a, D, DenseRows{S}, stream);
}

}  // namespace
}  // namespace repro

// q [B, Hq, D]; k_cache, v_cache [B, S, Hkv, D] (one layer of the model's
// [L, B, S, Hkv, D] cache: a contiguous slice, not a copy); lengths [B]
// int32; out [B, Hq, D].  All contiguous, q / caches / out of one dtype
// (0 = f32, 1 = bf16); D in {32, 64, 128}.  splits: the KV axis's split
// count (kernel.py's plan_splits); for splits > 1, part_o f32
// [B, Hq, splits, D] and part_ml f32 [B, Hq, splits, 2] are scratch, and
// counters int32 [B * Hkv * head chunks] must be zero (each launch leaves
// them zero again).
// Launches on `stream` and returns cudaGetLastError() after the launches.
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* lengths, void* out, int B,
                                      int S, int Hq, int Hkv, int D,
                                      int dtype, void* stream, int splits,
                                      void* part_o, void* part_ml,
                                      void* counters) {
  const repro::SplitArgs a{q, k_cache, v_cache, nullptr, nullptr,
                           lengths, out, B, Hq, Hkv, splits, part_o,
                           part_ml, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_dense<float, float>(a, S, D, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_dense<__nv_bfloat16, __nv_bfloat16>(a, S, D, s);
  return cudaErrorInvalidValue;
}

// As repro_decode_attention, with an int8 cache: k_cache, v_cache int8
// [B, S, Hkv, D] and k_scale, v_scale bf16 [B, S, Hkv] (slices of the
// model's int8 cache); q and out of `dtype` (0 = f32, 1 = bf16).
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths,
    void* out, int B, int S, int Hq, int Hkv, int D, int dtype,
    void* stream, int splits, void* part_o, void* part_ml,
    void* counters) {
  const repro::SplitArgs a{q, k_cache, v_cache, k_scale, v_scale,
                           lengths, out, B, Hq, Hkv, splits, part_o,
                           part_ml, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_dense<float, int8_t>(a, S, D, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_dense<__nv_bfloat16, int8_t>(a, S, D, s);
  return cudaErrorInvalidValue;
}

// The context-parallel shard's partial (see the header): as
// repro_decode_attention, but the merged state goes to o f32 [B, Hq, D]
// (unnormalised), m f32 [B, Hq] (natural log; -inf for a row with no
// valid slot) and l f32 [B, Hq] instead of an output.
extern "C" int repro_decode_attention_partial(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* o, void* m, void* l, int B, int S, int Hq,
    int Hkv, int D, int dtype, void* stream, int splits, void* part_o,
    void* part_ml, void* counters) {
  repro::SplitArgs a{q, k_cache, v_cache, nullptr, nullptr, lengths,
                     nullptr, B, Hq, Hkv, splits, part_o, part_ml,
                     counters};
  a.cp_o = o;
  a.cp_m = m;
  a.cp_l = l;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_dense<float, float>(a, S, D, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_dense<__nv_bfloat16, __nv_bfloat16>(a, S, D, s);
  return cudaErrorInvalidValue;
}

// The int8 cache's shard partial: repro_decode_attention_int8's inputs,
// repro_decode_attention_partial's outputs.
extern "C" int repro_decode_attention_int8_partial(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths, void* o,
    void* m, void* l, int B, int S, int Hq, int Hkv, int D, int dtype,
    void* stream, int splits, void* part_o, void* part_ml,
    void* counters) {
  repro::SplitArgs a{q, k_cache, v_cache, k_scale, v_scale, lengths,
                     nullptr, B, Hq, Hkv, splits, part_o, part_ml,
                     counters};
  a.cp_o = o;
  a.cp_m = m;
  a.cp_l = l;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_dense<float, int8_t>(a, S, D, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_dense<__nv_bfloat16, int8_t>(a, S, D, s);
  return cudaErrorInvalidValue;
}
