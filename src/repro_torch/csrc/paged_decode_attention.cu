// Paged decode attention for Hopper (sm_90a): one query token per request
// against a shared page pool [num_blocks, bt, Hkv, D], gathered through
// per-request block tables [B, max_blocks], masked at lengths[b].
//
// Replaces the TPU kernel `paged_decode_attention_kernel` (body
// `_paged_kernel`) in src/repro/kernels/decode_attention/kernel.py.
//
// What bounds it: bytes.  Each request's valid K/V (lengths[b] tokens of
// Hkv * D values, twice) is read once and every value feeds G = Hq / Hkv
// multiply-adds per score and per output, far below the ~295 operations
// per byte the card needs before arithmetic matters.  The bound counts a
// page that several requests share (a radix-cached prefix) once; the
// kernel reads it once per request that attends it, from L2 after the
// first.  Reading it once for all of them would need cascade attention
// (the shared prefix attended once for the whole group, then merged),
// which the reference does not have either, so where most of a batch's
// context is a shared prefix half the bound is out of reach.
//
// The design is decode_split.cuh's split-KV streaming kernel with token t
// of request b at row table[b][t / bt] * bt + t % bt of the pool: any bt,
// a warp tile's rows may span pages, and each lane reads its rows' table
// entries a tile ahead of the copies.  Only the first ceil(lengths[b] /
// bt) entries of a table are read, and only the rows below the length of
// their pages: pad entries may name any page (a foreign request's, or
// garbage) and the rows past the length in the last page may hold
// anything, NaN included; neither reaches the output.  The TPU grid
// stepped over all max_blocks entries and skipped the dead ones with
// pl.when.
#include "decode_split.cuh"

namespace repro {
namespace {

// A page pool [num_blocks, bt, Hkv, D] and block tables [B, max_blocks].
struct PagedRows {
  static constexpr bool kGather = true;
  const int* tables;
  int bt, max_blocks;
  __device__ int capacity() const { return bt * max_blocks; }
  __device__ int entry(int b, int t) const {
    return __ldg(tables + (size_t)b * max_blocks + t / bt);
  }
  __device__ size_t slot(int, int t, int page) const {
    return (size_t)page * bt + t % bt;
  }
};

template <typename T>
int launch_paged(const SplitArgs& a, int D, PagedRows rows,
                 cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  if (rows.bt <= 0 || rows.max_blocks <= 0 ||
      bad_split_args(a, rows.bt * rows.max_blocks))
    return cudaErrorInvalidValue;
  return launch_split_any<T, T>(a, D, rows, stream);
}

}  // namespace
}  // namespace repro

// q [B, Hq, D]; k_pages, v_pages [num_blocks, bt, Hkv, D]; block_tables
// [B, max_blocks] int32; lengths [B] int32; out [B, Hq, D].  All
// contiguous, q / pages / out of one dtype (0 = f32, 1 = bf16); D in
// {32, 64, 128}.  splits, part_o, part_ml and counters as for
// repro_decode_attention, with max_blocks * bt slots a request.
// Launches on `stream` and returns cudaGetLastError() after the launches.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int B, int Hq,
    int Hkv, int D, int bt, int max_blocks, int dtype, void* stream,
    int splits, void* part_o, void* part_ml, void* counters) {
  const repro::SplitArgs a{q, k_pages, v_pages, nullptr, nullptr,
                           lengths, out, B, Hq, Hkv, splits, part_o,
                           part_ml, counters};
  const repro::PagedRows rows{static_cast<const int*>(block_tables), bt,
                              max_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_paged<float>(a, D, rows, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_paged<__nv_bfloat16>(a, D, rows, s);
  return cudaErrorInvalidValue;
}
