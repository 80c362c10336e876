// Paged decode attention for Hopper (sm_90a): one query token per request
// against a shared page pool, gathered through per-request block tables.
//
// Replaces the TPU kernel `paged_decode_attention_kernel` (body
// `_paged_kernel`) in src/repro/kernels/decode_attention/kernel.py.
//
// What bounds it: bytes.  Each request's valid K/V (lengths[b] tokens of
// Hkv * D values, twice) is read once and every value feeds G = Hq / Hkv
// multiply-adds per score and per output, far below the ~295 operations
// per byte the card needs before arithmetic matters.  The design therefore
// reads only the pages a row needs: one block per (request, KV head) walks
// ceil(lengths[b] / bt) pages of its own table and never touches a pad
// table entry, where the TPU grid stepped over all max_blocks entries and
// skipped the dead ones with pl.when.  All G query heads of the KV head
// share each staged page, so a page is read once per KV head.  Softmax is
// online in f32 (running max, sum and [G, D] accumulator in shared
// memory), as on the TPU; q is scaled by D**-0.5 in f32 before the dot.
//
// Simple first: scalar loads, f32 FMAs, no tensor cores and no split over
// the KV axis; B * Hkv blocks fill the card only at large batch.
#include <cmath>

#include "attention_common.cuh"

namespace repro {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Hq, int Hkv, int D, int bt, int max_blocks,
                    float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv, ld = D + 1;
  float* qs = smem;              // [G][ld]   scaled queries
  float* ks = qs + G * ld;       // [bt][ld]  staged K page
  float* vs = ks + bt * ld;      // [bt][ld]  staged V page
  float* sc = vs + bt * ld;      // [G][bt]   scores, then probabilities
  float* acc = sc + G * bt;      // [G][D]    f32 accumulator
  float* m = acc + G * D;        // [G]       running max
  float* l = m + G;              // [G]       running sum
  float* alpha = l + G;          // [G]       per-step rescale

  const int len = lengths[b];
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
  const int n_pages = min((len + bt - 1) / bt, max_blocks);
  const int* table = block_tables + (size_t)b * max_blocks;
  for (int j = 0; j < n_pages; ++j) {
    __syncthreads();  // the previous page's tiles are consumed
    const size_t page = (size_t)table[j] * bt;
    const int base = j * bt;
    auto row_off = [&](int t) { return ((page + t) * Hkv + h) * D; };
    auto ok = [&](int t) { return base + t < len; };
    stage_rows(ks, ld, k_pages, bt, D, row_off, ok);
    stage_rows(vs, ld, v_pages, bt, D, row_off, ok);
    __syncthreads();
    tile_scores(sc, qs, ks, ld, G, bt, D,
                [&](int, int t) { return base + t < len; });
    __syncthreads();
    softmax_step(sc, G, bt, m, l, alpha);
    __syncthreads();
    tile_pv(acc, sc, vs, alpha, ld, G, bt, D);
  }
  __syncthreads();
  T* orow = out + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    orow[e] = from_f32<T>(acc[e] / fmaxf(l[e / D], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lengths, void* out,
                   int B, int Hq, int Hkv, int D, int bt, int max_blocks,
                   cudaStream_t stream) {
  const int G = Hq / Hkv, ld = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)G * ld + 2 * (size_t)bt * ld + G * bt +
                       (size_t)G * D + 3 * G);
  cudaError_t err = set_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), Hq, Hkv, D, bt,
      max_blocks, static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, Hq, D]; k_pages, v_pages [num_blocks, bt, Hkv, D]; block_tables
// [B, max_blocks] int32; lengths [B] int32; out [B, Hq, D].  All
// contiguous, q / pages / out of one dtype (0 = f32, 1 = bf16).  Launches
// on `stream` and returns cudaGetLastError() after the launch.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int B, int Hq,
    int Hkv, int D, int bt, int max_blocks, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || bt <= 0 ||
      max_blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k_pages, v_pages, block_tables, lengths,
                                out, B, Hq, Hkv, D, bt, max_blocks, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                        lengths, out, B, Hq, Hkv, D, bt,
                                        max_blocks, s);
  return cudaErrorInvalidValue;
}
