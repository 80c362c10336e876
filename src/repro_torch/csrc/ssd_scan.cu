// Mamba2 SSD chunked scan for Hopper (sm_90a), in f32.
//
// Replaces the TPU kernel `ssd_scan_kernel` (body `_kernel`) in
// src/repro/kernels/ssd_scan/kernel.py.  For one (row, head) and a chunk
// of C rows with cumulative log-decay cum_i = sum_{t<=i} dt_t * a:
//
//   intra:  y_i  = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//   inter:  y_i += exp(cum_i) state_in c_i
//   state:  state = exp(cum_C) state_in
//                   + sum_j exp(cum_C - cum_j) dt_j x_j b_j^T
//
// Grid: one block per (row, head).  The TPU grid's sequential third axis
// (the chunks, carrying the [P, N] f32 state in VMEM scratch) becomes a
// loop inside the block, with the state in shared memory; blocks share
// nothing.  b and c are shared by every head, so each head's block reads
// them again; L2 absorbs that.
//
// Shared memory: at mamba2-780m's shapes (P 64, N 128, C 128) the state
// alone is 32 KB, and staging x [C, P], b and c [C, N] and the [C, C]
// decay tile whole would pass the 227 KB a block may have.  So the chunk
// is walked in tiles of 32 rows: the c rows of one query tile, the b and
// x rows of one key tile, their 32 x 32 weight tile and the query tile's
// [32, P] accumulator (~88 KB in all, dynamic shared memory).
//
// Decay: exp(cum_i - cum_j) is computed only where i >= j.  Above the
// diagonal the exponent is positive and can overflow, and inf * 0 is NaN,
// so a masked term is set to zero, never multiplied by a zero mask.
//
// Ragged S: the TPU wrapper shrinks the chunk until it divides S.  Here
// the chunk stays and the tail rows of the last chunk are staged with
// dt = 0, x = b = c = 0: such a row adds nothing to the state and leaves
// its decay at 1, and its y is never written.  Tiles wholly past the
// last valid row are skipped, so a short sequence does not pay for a
// whole chunk.
//
// What bounds it: operations.  Per (row, chunk) the function does ~250
// MFLOP (C.B^T once, then for each of 48 heads the weighted sum over x,
// the carried-state term and the state update) against ~3.3 MB of x, y,
// b and c: ~80 operations per byte, above the f32 CUDA cores' ~20 (67
// TFLOP/s against 3.35 TB/s).  This kernel does more: each head's block
// forms C.B^T again, ~4 M FMAs per (row, head, chunk) in all, as scalar
// f32 FMAs from shared memory, rows padded to N + 1 floats so the lanes of
// a warp hit distinct banks.  The chunked form is kept, not the per-token
// recurrence, because its three products are matrix products: moving
// them onto the tensor cores (wgmma on the 64-row tiles) is a later PR's
// work.  expf, not __expf, so the decay keeps full f32 precision.
#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int kScanThreads = 256;
constexpr int kRows = 32;    // chunk rows per staged tile

__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N,
                int C) {
  extern __shared__ float smem[];
  constexpr int T = kRows;
  const int h = blockIdx.x, row = blockIdx.y;
  const int ldn = N + 1, ldw = T + 1;
  float* st = smem;              // [P][ldn]  carried state
  float* cum = st + P * ldn;     // [C]       cumulative log-decay
  float* dts = cum + C;          // [C]       dt of the chunk's rows
  float* ct = dts + C;           // [T][ldn]  c rows of the query tile
  float* bt = ct + T * ldn;      // [T][ldn]  b rows of the key tile
  float* xt = bt + T * ldn;      // [T][P]    x rows of the key tile
  float* wt = xt + T * P;        // [T][ldw]  weights of (query, key) pairs
  float* ya = wt + T * ldw;      // [T][P]    y of the query tile
  const int tid = threadIdx.x, nt = blockDim.x;
  const float ah = a[h];

  // token s's offsets in x / y, dt, and b / c
  auto x_off = [&](int s) { return (((size_t)row * S + s) * H + h) * P; };
  auto dt_off = [&](int s) { return ((size_t)row * S + s) * H + h; };
  auto bc_off = [&](int s) { return ((size_t)row * S + s) * N; };
  // stage n rows (chunk rows r0 + t) of b or c; rows past `rows` as zeros
  auto stage_bc = [&](float* dst, const float* src, int c0, int r0,
                      int rows) {
    for (int e = tid; e < T * N; e += nt) {
      const int t = e / N, n = e - t * N;
      dst[t * ldn + n] = r0 + t < rows ? src[bc_off(c0 + r0 + t) + n] : 0.f;
    }
  };

  for (int e = tid; e < P * N; e += nt) st[(e / N) * ldn + e % N] = 0.f;

  for (int c0 = 0; c0 < S; c0 += C) {
    const int rows = min(C, S - c0);          // valid rows of this chunk
    __syncthreads();                          // the last chunk is done
    for (int t = tid; t < C; t += nt)
      dts[t] = t < rows ? dt[dt_off(c0 + t)] : 0.f;
    __syncthreads();
    if (tid < 32) {                           // one warp scans dt * a
      float carry = 0.f;
      for (int base = 0; base < C; base += 32) {
        const int t = base + tid;
        float v = t < C ? dts[t] * ah : 0.f;
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (t < C) cum[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float tot = cum[rows - 1];

    // y, one query tile of T rows at a time, from the state carried in
    for (int i0 = 0; i0 < rows; i0 += T) {
      __syncthreads();                        // ct and ya are free
      stage_bc(ct, cm, c0, i0, rows);
      __syncthreads();
      for (int e = tid; e < T * P; e += nt) { // inter-chunk term
        const int r = e / P, p = e - r * P;
        float s = 0.f;
        if (i0 + r < rows) {
          const float* cr = ct + r * ldn;
          const float* sp = st + p * ldn;
          for (int n = 0; n < N; ++n) s = fmaf(cr[n], sp[n], s);
          s *= expf(cum[i0 + r]);
        }
        ya[e] = s;
      }
      for (int j0 = 0; j0 <= i0; j0 += T) {   // key tiles up to the diagonal
        __syncthreads();                      // bt, xt and wt are free
        stage_bc(bt, bm, c0, j0, rows);
        for (int e = tid; e < T * P; e += nt) {
          const int t = e / P, p = e - t * P;
          xt[e] = j0 + t < rows ? x[x_off(c0 + j0 + t) + p] : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < T * T; e += nt) {
          const int r = e / T, q = e - r * T;
          const int gi = i0 + r, gj = j0 + q;
          float w = 0.f;                      // masked: zero, not 0 * exp
          if (gj <= gi && gi < rows) {
            const float* cr = ct + r * ldn;
            const float* bq = bt + q * ldn;
            float s = 0.f;
            for (int n = 0; n < N; ++n) s = fmaf(cr[n], bq[n], s);
            w = s * expf(cum[gi] - cum[gj]) * dts[gj];
          }
          wt[r * ldw + q] = w;
        }
        __syncthreads();
        for (int e = tid; e < T * P; e += nt) {
          const int r = e / P, p = e - r * P;
          const float* wr = wt + r * ldw;
          float acc = ya[e];
          for (int q = 0; q < T; ++q) acc = fmaf(wr[q], xt[q * P + p], acc);
          ya[e] = acc;
        }
      }
      __syncthreads();
      for (int e = tid; e < T * P; e += nt) {
        const int r = e / P, p = e - r * P;
        if (i0 + r < rows) y[x_off(c0 + i0 + r) + p] = ya[e];
      }
    }

    // state = exp(tot) state_in + sum_j (x_j exp(tot - cum_j) dt_j) b_j^T
    __syncthreads();                          // every y read state_in
    const float etot = expf(tot);
    for (int e = tid; e < P * N; e += nt) st[(e / N) * ldn + e % N] *= etot;
    for (int j0 = 0; j0 < rows; j0 += T) {
      __syncthreads();                        // bt and xt are free
      stage_bc(bt, bm, c0, j0, rows);
      for (int e = tid; e < T * P; e += nt) {
        const int t = e / P, p = e - t * P;
        const int gj = j0 + t;
        xt[e] = gj < rows ? x[x_off(c0 + gj) + p] *
                                (dts[gj] * expf(tot - cum[gj]))
                          : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < P * N; e += nt) {
        const int p = e / N, n = e - p * N;
        float acc = st[p * ldn + n];
        for (int q = 0; q < T; ++q)
          acc = fmaf(xt[q * P + p], bt[q * ldn + n], acc);
        st[p * ldn + n] = acc;
      }
    }
  }
  __syncthreads();
  float* so = state_out + ((size_t)row * H + h) * P * N;
  for (int e = tid; e < P * N; e += nt) so[e] = st[(e / N) * ldn + e % N];
}

}  // namespace
}  // namespace repro

// x [B, S, H, P]; dt [B, S, H]; a [H]; b, c [B, S, N]; y [B, S, H, P];
// state [B, H, P, N]: all f32 and contiguous.  `chunk` is the scan's
// chunk length C (the tail of a ragged last chunk is masked).  Launches
// on `stream` and returns cudaGetLastError() after the launch.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, void* y,
                              void* state, int B, int S, int H, int P, int N,
                              int chunk, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (B < 0 || S <= 0 || H < 0 || P <= 0 || N <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const int C = chunk < S ? chunk : S;
  constexpr int T = repro::kRows;
  const size_t smem =
      sizeof(float) * ((size_t)P * (N + 1) + 2 * (size_t)C +
                       2 * (size_t)T * (N + 1) + 2 * (size_t)T * P +
                       (size_t)T * (T + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        repro::ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  repro::ssd_scan_kernel<<<dim3(H, B), repro::kScanThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, N, C);
  return cudaGetLastError();
}
