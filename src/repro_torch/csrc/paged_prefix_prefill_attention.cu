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
// row, G = Hq / Hkv query heads per KV head) the bytes read, the prefix
// pages above all: each K/V value feeds 2 * S * G multiply-adds at most,
// far below the ~295 operations per byte of the bf16 tensor cores.  The
// TPU kernel bought "bandwidth follows the real prefix" with a DMA clamp
// (re-referencing the last valid page on dead grid steps); here a block
// reads only the table entries and pages below prefix_lens[b], so a miss
// row reads no page at all, whatever the table width, and suffix keys
// only up to its last query row's position.  Rows are packed as the TPU
// kernel packs them: row r of the S * G rows of a KV head is suffix
// position r / G, query head h * G + r % G, so the G query heads of one
// KV head share each K/V tile.
//
// bf16 (the serves): `prefix_prefill_tc_kernel`, on the tensor cores.
// One block per (64 packed query rows, KV head, request), one consumer
// warpgroup.  Q comes by cp.async into the swizzled tile layout; then the
// block walks 64-key K/V tiles, first the prefix (key p at row
// table[b][p / bt] * bt + p % bt of the pool), then the suffix, each
// gathered row by row with 16-byte cp.async into the same layout, two
// tiles ahead of the one it computes (a 3-stage ring, one barrier a
// tile).  A key that no row may see (past prefix_lens, past the suffix
// end, or behind a pad table entry) is zero-filled and never read: its
// score is masked to -inf, so p = 0, and a zero V row keeps 0 * NaN out
// of the P.V product.  The tile step itself (S = Q.K^T and O += P.V by
// wgmma, the online softmax in registers) is attention_tc.cuh's, shared
// with the dense flash kernel.  Head sizes 32, 64 and 128.
//
// f32: `prefix_prefill_kernel`, the scalar kernel of the first port.  Its
// callers hold it to 2e-4 of the plain f32 version, which needs true f32
// products.  16-row tiles, online softmax in f32 with the [16, D]
// accumulator in shared memory, scalar loads and FMAs; every q tile
// re-reads the prefix pages of its row.
#include <cmath>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "hopper_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kPpStages = 3;  // K/V ring depth: two tiles in flight

template <int D>
constexpr int pp_smem() {
  return 1024 + TcTile<D>::BYTES * (1 + 2 * kPpStages);
}

template <int D>
__global__ void __launch_bounds__(128)
prefix_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_suf,
                         const __nv_bfloat16* __restrict__ v_suf,
                         const __nv_bfloat16* __restrict__ k_pages,
                         const __nv_bfloat16* __restrict__ v_pages,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ prefix_lens,
                         const int* __restrict__ suffix_lens,
                         __nv_bfloat16* __restrict__ out, int S, int Hq,
                         int Hkv, int bt, int max_blocks, float scale_log2) {
  constexpr int TB = TcTile<D>::BYTES, BN = kTcKeys;
  constexpr int CPRow = D / 8;  // 16-byte chunks a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = qs + TB;  // [stage][K tile, V tile]

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.x * kTcRows;
  const int R = min(kTcRows, S * G - r0);
  const int p_lo = r0 / G, p_hi = (r0 + R - 1) / G;
  const int plen = min(max(prefix_lens[b], 0), bt * max_blocks);
  // suffix keys any row of this tile can see: [0, kend)
  const int kend = max(0, min(min(suffix_lens[b], S), p_hi + 1));
  const int np = (plen + BN - 1) / BN;
  const int ntiles = np + (kend + BN - 1) / BN;
  const int* table = block_tables + (size_t)b * max_blocks;
  const size_t hoff = (size_t)h * D;

  auto qoff = [&](int r) {  // element offset of packed row r in q / out
    return (((size_t)b * S + r / G) * Hq + (size_t)h * G + r % G) * D;
  };
  for (int e = tid; e < kTcRows * CPRow; e += 128) {
    const int row = e / CPRow, cc = e % CPRow;
    const bool ok = row < R;
    cp_async16(qs + tc_chunk<D>(row, cc),
               q + (ok ? qoff(r0 + row) + cc * 8 : 0), ok);
  }
  // tile j's K and V rows into stage j % kPpStages; keys no row may see
  // are zero-filled without a read (nor a read of their table entry)
  auto issue = [&](int j) {
    unsigned char* kt = ring + (j % kPpStages) * 2 * TB;
    unsigned char* vt = kt + TB;
    const bool pre = j < np;
    const int c0 = (pre ? j : j - np) * BN;
    const __nv_bfloat16* kx = pre ? k_pages : k_suf;
    const __nv_bfloat16* vx = pre ? v_pages : v_suf;
    for (int e = tid; e < BN * CPRow; e += 128) {
      const int row = e / CPRow, cc = e % CPRow, key = c0 + row;
      const bool ok = key < (pre ? plen : kend);
      size_t src = 0;
      if (ok) {
        const size_t slot = pre ? (size_t)table[key / bt] * bt + key % bt
                                : (size_t)b * S + key;
        src = slot * Hkv * D + hoff + cc * 8;
      }
      const uint32_t o = tc_chunk<D>(row, cc);
      cp_async16(kt + o, kx + src, ok);
      cp_async16(vt + o, vx + src, ok);
    }
  };
  // group 0: Q and tile 0; group 1: tile 1; then one group a tile
  if (ntiles > 0) issue(0);
  cp_async_commit();
  if (ntiles > 1) issue(1);
  cp_async_commit();

  int qp[2];  // suffix positions of this thread's two rows
  for (int hr = 0; hr < 2; ++hr) qp[hr] = (r0 + tc_row(hr)) / G;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<1>();  // this thread's copies of tile j (and Q) landed
    fence_proxy_async();  // visible to wgmma
    __syncthreads();      // every thread's, and tile j - 1 is consumed
    if (j + 2 < ntiles) issue(j + 2);
    cp_async_commit();
    const unsigned char* kt = ring + (j % kPpStages) * 2 * TB;
    const bool pre = j < np;
    const int c0 = (pre ? j : j - np) * BN;
    // masks, only where some key of the tile is hidden from some row
    const bool edge =
        pre ? c0 + BN > plen : (c0 + BN > kend || c0 + BN - 1 > p_lo);
    tc_attend_tile<D>(
        qs, kt, kt + TB, edge,
        [&](int col, int hr) {
          const int k = c0 + col;
          return pre ? k >= plen : (k >= kend || k > qp[hr]);
        },
        scale_log2, o, m, l);
  }
  cp_async_wait_all();
  tc_store<D>(o, l, R, [&](int lr) { return out + qoff(r0 + lr); });
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k_suf, const void* v_suf,
                      const void* k_pages, const void* v_pages,
                      const void* block_tables, const void* prefix_lens,
                      const void* suffix_lens, void* out, int B, int S,
                      int Hq, int Hkv, int bt, int max_blocks,
                      cudaStream_t stream) {
  constexpr size_t smem = pp_smem<D>();
  cudaError_t err = set_smem(prefix_prefill_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const dim3 grid((S * G + kTcRows - 1) / kTcRows, Hkv, B);
  using bf16 = __nv_bfloat16;
  prefix_prefill_tc_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_suf),
      static_cast<const bf16*>(v_suf), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(prefix_lens),
      static_cast<const int*>(suffix_lens), static_cast<bf16*>(out), S, Hq,
      Hkv, bt, max_blocks,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))) * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k_suf, const void* v_suf,
                        const void* k_pages, const void* v_pages,
                        const void* block_tables, const void* prefix_lens,
                        const void* suffix_lens, void* out, int B, int S,
                        int Hq, int Hkv, int D, int bt, int max_blocks,
                        cudaStream_t stream) {
#define REPRO_LAUNCH(DD)                                                    \
  return launch_tc<DD>(q, k_suf, v_suf, k_pages, v_pages, block_tables,     \
                       prefix_lens, suffix_lens, out, B, S, Hq, Hkv, bt,    \
                       max_blocks, stream)
  switch (D) {
    case 32: REPRO_LAUNCH(32);
    case 64: REPRO_LAUNCH(64);
    case 128: REPRO_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}

}  // namespace
}  // namespace repro

// q [B, S, Hq, D]; k_suf, v_suf [B, S, Hkv, D]; k_pages, v_pages
// [num_blocks, bt, Hkv, D]; block_tables [B, max_blocks] int32 (max_blocks
// may be 1 for a wave with no cached prefix); prefix_lens, suffix_lens [B]
// int32; out [B, S, Hq, D].  All contiguous, float tensors of one dtype
// (0 = f32, 1 = bf16); bf16 takes D in {32, 64, 128} and every tensor on
// a 16-byte boundary.  Launches on `stream` and returns
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
    return repro::launch_bf16(q, k_suf, v_suf, k_pages, v_pages,
                              block_tables, prefix_lens, suffix_lens, out, B,
                              S, Hq, Hkv, D, bt, max_blocks, s);
  return cudaErrorInvalidValue;
}
