// Suffix-prefill attention against cached prefix pages, for Hopper
// (sm_90a).  The suffix queries of a request attend every cached prefix
// position < prefix_lens[b] (gathered from the shared page pool through
// the request's block table), then the suffix's own K/V causally, masked
// at and past suffix_lens[b].  prefix_lens[b] may be 0 (a radix miss).
//
// Replaces the TPU kernel `paged_prefix_prefill_attention_kernel` (body
// `_prefix_prefill_kernel`) in src/repro/kernels/decode_attention/kernel.py.
//
// What bounds it: at the serving shapes (a few dozen suffix tokens per
// row, G = Hq / Hkv query heads per KV head) each staged K/V value feeds
// 2 * TQ multiply-adds per tile, so the kernel is bound by bytes read, the
// prefix pages above all.  The TPU kernel bought "bandwidth follows the
// real prefix" with a DMA clamp (re-referencing the last valid page on
// dead grid steps); here a block simply loops over ceil(prefix_lens[b] /
// bt) pages of its own table and stops, so a miss row reads no page at
// all, whatever the table width.  Suffix keys are walked in chunks of bt
// only up to the tile's last query position.
//
// One block per (request, KV head, tile of TQ rows of the S * G query
// rows); row r is suffix position r / G, query head h * G + r % G, the
// same row order as the TPU kernel's [S * G, D] tile.  Softmax is online
// in f32 with the [TQ, D] accumulator in shared memory.  Simple first:
// scalar loads, f32 FMAs, no tensor cores; every q tile re-reads the
// prefix pages of its row.
#include <cmath>

#include "attention_common.cuh"

namespace repro {
namespace {

constexpr int kTileRows = 16;  // TQ

template <typename T>
__global__ void __launch_bounds__(kThreads)
prefix_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_suf,
                      const T* __restrict__ v_suf,
                      const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ prefix_lens,
                      const int* __restrict__ suffix_lens,
                      T* __restrict__ out, int S, int Hq, int Hkv, int D,
                      int bt, int max_blocks, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, ld = D + 1;
  const int r0 = blockIdx.x * kTileRows;
  const int R = min(kTileRows, S * G - r0);
  float* qs = smem;                   // [TQ][ld]  scaled queries
  float* ks = qs + kTileRows * ld;    // [bt][ld]  staged K chunk
  float* vs = ks + bt * ld;           // [bt][ld]  staged V chunk
  float* sc = vs + bt * ld;           // [TQ][bt]  scores, then probabilities
  float* acc = sc + kTileRows * bt;   // [TQ][D]   f32 accumulator
  float* m = acc + kTileRows * D;     // [TQ]
  float* l = m + kTileRows;           // [TQ]
  float* alpha = l + kTileRows;       // [TQ]

  // element offset of query row r (suffix position, query head) in q / out
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

  // 1. cached prefix: only the pages this row's prefix covers
  const int plen = prefix_lens[b];
  const int n_pages = min((plen + bt - 1) / bt, max_blocks);
  const int* table = block_tables + (size_t)b * max_blocks;
  for (int j = 0; j < n_pages; ++j) {
    __syncthreads();
    const size_t page = (size_t)table[j] * bt;
    const int base = j * bt;
    auto row_off = [&](int t) { return ((page + t) * Hkv + h) * D; };
    auto ok = [&](int t) { return base + t < plen; };
    stage_rows(ks, ld, k_pages, bt, D, row_off, ok);
    stage_rows(vs, ld, v_pages, bt, D, row_off, ok);
    __syncthreads();
    tile_scores(sc, qs, ks, ld, R, bt, D,
                [&](int, int t) { return base + t < plen; });
    __syncthreads();
    softmax_step(sc, R, bt, m, l, alpha);
    __syncthreads();
    tile_pv(acc, sc, vs, alpha, ld, R, bt, D);
  }

  // 2. the suffix itself: key k is visible to row r iff k <= r / G and
  //    k < suffix_lens[b]; keys past the tile's last row are never read
  const int slen = suffix_lens[b];
  const int kend = min(min(slen, S), (r0 + R - 1) / G + 1);
  for (int c0 = 0; c0 < kend; c0 += bt) {
    __syncthreads();
    auto row_off = [&](int t) {
      return (((size_t)b * S + c0 + t) * Hkv + h) * D;
    };
    auto ok = [&](int t) { return c0 + t < kend; };
    stage_rows(ks, ld, k_suf, bt, D, row_off, ok);
    stage_rows(vs, ld, v_suf, bt, D, row_off, ok);
    __syncthreads();
    tile_scores(sc, qs, ks, ld, R, bt, D, [&](int r, int t) {
      const int k = c0 + t;
      return k < kend && k <= (r0 + r) / G;
    });
    __syncthreads();
    softmax_step(sc, R, bt, m, l, alpha);
    __syncthreads();
    tile_pv(acc, sc, vs, alpha, ld, R, bt, D);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    out[qoff(r) + d] = from_f32<T>(acc[e] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_suf, const void* v_suf,
                   const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* prefix_lens,
                   const void* suffix_lens, void* out, int B, int S, int Hq,
                   int Hkv, int D, int bt, int max_blocks,
                   cudaStream_t stream) {
  const int G = Hq / Hkv, ld = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)kTileRows * ld + 2 * (size_t)bt * ld +
                       kTileRows * bt + (size_t)kTileRows * D +
                       3 * kTileRows);
  cudaError_t err = set_smem(prefix_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S * G + kTileRows - 1) / kTileRows, Hkv, B);
  prefix_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_suf),
      static_cast<const T*>(v_suf), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(prefix_lens),
      static_cast<const int*>(suffix_lens), static_cast<T*>(out), S, Hq, Hkv,
      D, bt, max_blocks,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q [B, S, Hq, D]; k_suf, v_suf [B, S, Hkv, D]; k_pages, v_pages
// [num_blocks, bt, Hkv, D]; block_tables [B, max_blocks] int32 (max_blocks
// may be 1 for a wave with no cached prefix); prefix_lens, suffix_lens [B]
// int32; out [B, S, Hq, D].  All contiguous, float tensors of one dtype
// (0 = f32, 1 = bf16).  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int repro_paged_prefix_prefill_attention(
    const void* q, const void* k_suf, const void* v_suf, const void* k_pages,
    const void* v_pages, const void* block_tables, const void* prefix_lens,
    const void* suffix_lens, void* out, int B, int S, int Hq, int Hkv, int D,
    int bt, int max_blocks, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (B < 0 || S < 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || bt <= 0 ||
      max_blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k_suf, v_suf, k_pages, v_pages,
                                block_tables, prefix_lens, suffix_lens, out,
                                B, S, Hq, Hkv, D, bt, max_blocks, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k_suf, v_suf, k_pages, v_pages,
                                        block_tables, prefix_lens,
                                        suffix_lens, out, B, S, Hq, Hkv, D,
                                        bt, max_blocks, s);
  return cudaErrorInvalidValue;
}
