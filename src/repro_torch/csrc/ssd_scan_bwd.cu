// The gradient of the Mamba2 SSD chunked scan for Hopper (sm_90a): f32 in
// and out, on the CUDA cores in plain f32.
//
// Replaces no TPU kernel: no TPU kernel of the repository has a backward.
// The JAX package differentiates its plain `jnp` scan
// (`ssd_chunked`, src/repro/models/ssm.py), and its Pallas scan
// (src/repro/kernels/ssd_scan/kernel.py) serves prefill only.  The port's
// forward (ssd_scan.cu) is reached through ctypes, where autograd cannot
// see, so its gradient is a kernel too.  The plain version it mirrors is
// `ssd_scan_bwd_ref` (kernels/ssd_scan/ref.py), whose docstring gives the
// formulas.  For one (row, head) and a chunk of C rows with cum_i =
// sum_{t<=i} dt_t a, tot = cum_last, G = C.B^T, L_ij = exp(cum_i - cum_j)
// (i >= j), u_j = exp(tot - cum_j) dt_j, incoming state S_in and outgoing
// state gradient dS:
//
//   dS_in  = exp(tot) dS + sum_i exp(cum_i) dy_i c_i^T
//   dx_j   = u_j dS b_j + dt_j sum_i (G o L)_ij dy_i
//   db_j   = u_j dS^T x_j + sum_i dG_ij c_i      (summed over the heads)
//   dc_i   = exp(cum_i) S_in^T dy_i + sum_j dG_ij b_j   (over the heads)
//   dW_ij  = dy_i . x_j,  dG_ij = dW_ij L_ij dt_j,  R_ij = dW_ij G_ij L_ij
//   ddt_j  = du_j exp(tot - cum_j) + sum_i R_ij + a ds_j
//   dcum_i = exp(cum_i) dy_i . (S_in c_i) - du_i u_i + sum_j R_ij dt_j
//            - dt_i sum_j R_ji,  du_j = x_j . dS b_j
//   dtot   = exp(tot) <dS, S_in> + sum_j du_j u_j   (into dcum_last)
//   ds     = reverse cumsum of dcum;  da = sum ds dt over rows and positions
//
// The incoming states: the forward writes them when given a pointer
// ([B, n_chunks, H, P, N] f32, 25 MB a layer at mamba2-780m's B 8, S
// 256), as the flash forwards write their log-sum-exp.  Recomputing them
// would repeat the forward's state pass (a third of its products) in
// every backward, where the store costs one write of the registers the
// forward already holds; with the training path's recompute the states
// live for one layer's backward only.
//
// G = C_z . B_z^T is the forward's: its `ssd_cb_kernel` writes the lower
// triangle into an f32 scratch [B, n_chunks, Cp, Cp] (Cp = C rounded up
// to 16; 1 MB at mamba2-780m's B 8, S 256), which the caller keeps for
// the backward beside the states, so G is formed once (in 3xTF32) for
// both passes.
//
// One call runs four kernels on the stream, each block a 16 x 16 grid of
// threads that owns rows ty + 16 u and columns tx + 16 v of every product
// (plain f32 FMAs from shared memory):
// 1. `ssd_bwd_chain_kernel`, per (head, row): walks the chunks in reverse
//    with dS in registers, writing each chunk's dS into a scratch [B,
//    n_chunks, H, P, N] (the sequential axis; 1/n_chunks of the work).
// 2. `ssd_bwd_state_kernel`, per (head, chunk, row): every term that
//    reads S_in or dS (four products of C x P x N), writing dx, ddt, the
//    per-head partials of db and dc, and each row's dcum.
// 3. `ssd_bwd_intra_kernel`, per (head, chunk, row): the intra term (dW,
//    then dx, R's sums, dG in place, dc and db), adding to what (2)
//    wrote, then the reverse cumsum of dcum (in f64, one thread: da sums
//    long runs of both signs), ddt, and a per-block partial of da.
// 4. `ssd_bwd_reduce_kernel`: db and dc summed over the heads, da over
//    the rows and chunks, in a fixed order.
// No atomics: every partial is written by one block and summed in a fixed
// order, so two launches give the same bits.
//
// Decay: exp(cum_i - cum_j) is computed only where i >= j (above the
// diagonal it can overflow, and inf * 0 is NaN); a masked entry is set to
// zero, never multiplied by a zero mask, so its gradient is exactly zero.
//
// Ragged S: as in the forward, the chunk stays C = min(chunk, S) and the
// rows of the last chunk past S are staged with dt = 0 and x = dy = b = c
// = 0; tot is the cumulative decay at the last row before S, and no
// gradient of a row past S is written.
//
// Widths: P <= 64, N <= 128 (padded to 16 in shared memory; the products'
// column tiles are instantiated for N <= 32, 64 and 128), C <= 128, the
// forward's.  Shared memory at P 64, N 128, C 128: 211 KB for (2), 201 KB
// for (3): one block an SM.
//
// What bounds it: per (row, chunk, head) the function does about C^2 P +
// 5 C P N multiply-adds (G comes from the forward), 20 MFLOP at
// mamba2-780m's widths, against ~0.4 MB of inputs and outputs: the f32
// operations bound it, at the card's f32 rate (3xTF32 on the tensor
// cores, 495 / 3 TFLOP/s; 67 on the CUDA cores this kernel uses).  This
// first kernel computes the triangles in full (about 1.5x the work), at
// one block of 8 warps an SM with every operand read from shared memory
// (two loads a multiply-add pair), so latency and issue bound it well
// above that.
#include <cuda_runtime.h>

#include <cstddef>

namespace repro {
namespace {

constexpr int kThreads = 256;    // a 16 x 16 grid of output owners
constexpr int kMaxChunk = 128;

__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;
}

// acc[u][v] += sum_{k < kd} fa(i, k) fb(k, j) over this thread's rows i =
// ty + 16 u < m and columns j = tx + 16 v < n (m, n multiples of 16).
template <int TM, int TN, typename FA, typename FB>
__device__ __forceinline__ void gemm(float (&acc)[TM][TN], int m, int n,
                                     int kd, FA fa, FB fb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < kd; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u)
      av[u] = ty + 16 * u < m ? fa(ty + 16 * u, k) : 0.f;
#pragma unroll
    for (int v = 0; v < TN; ++v)
      bv[v] = tx + 16 * v < n ? fb(k, tx + 16 * v) : 0.f;
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
}

// fn(i, j, acc[u][v]) for this thread's rows i < m and columns j < n.
template <int TM, int TN, typename F>
__device__ __forceinline__ void each(const float (&acc)[TM][TN], int m,
                                     int n, F fn) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v)
      if (ty + 16 * u < m && tx + 16 * v < n)
        fn(ty + 16 * u, tx + 16 * v, acc[u][v]);
}

// part[i * 16 + tx] = sum over this thread's columns j < n of w(i, j)
// acc[u][v], for its rows i < m: one slot a (row, tx), so the row sums
// (summed over tx in order by `row_sums`) need no atomics.
template <int TM, int TN, typename F>
__device__ __forceinline__ void row_parts(const float (&acc)[TM][TN], int m,
                                          int n, float* part, F w) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int i = ty + 16 * u;
    if (i >= m) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < TN; ++v)
      if (tx + 16 * v < n) s = fmaf(w(i, tx + 16 * v), acc[u][v], s);
    part[i * 16 + tx] = s;
  }
}

__device__ __forceinline__ float row_sum(const float* part, int i) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 16; ++t) s += part[i * 16 + t];
  return s;
}

// dst[r * ld + q] = src[r * gs + q] for r < rows and q < cols, zero for
// the rest of rp rows and cp columns.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t gs, int rows, int rp, int cols,
                                      int cp) {
  for (int e = threadIdx.x; e < rp * cp; e += kThreads) {
    const int r = e / cp, q = e - r * cp;
    dst[r * ld + q] = r < rows && q < cols ? __ldg(src + r * gs + q) : 0.f;
  }
}

// dts[i] = dt of the chunk's row i for i < rows, zero up to rp.
__device__ __forceinline__ void stage_dt(float* dts, const float* dt,
                                         size_t tok0, int H, int h, int rows,
                                         int rp) {
  for (int i = threadIdx.x; i < rp; i += kThreads)
    dts[i] = i < rows ? __ldg(dt + (tok0 + i) * H + h) : 0.f;
}

// cum[i] = sum_{t <= i} dt_t a (constant past the last row), by one
// thread in order, so every kernel of the call gets the same bits.
__device__ __forceinline__ void chunk_cum(const float* dts, float* cum,
                                          float ah, int rp) {
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < rp; ++i) {
      s += dts[i] * ah;
      cum[i] = s;
    }
  }
}

// The geometry of one chunk of one row.
struct Chunk {
  int rows, rp;        // valid rows, rounded up to 16
  size_t tok0;         // token index (row * S + c0) of its first row
  __device__ Chunk(int row, int z, int S, int C) {
    const int c0 = z * C;
    rows = min(C, S - c0);
    rp = up16(rows);
    tok0 = (size_t)row * S + c0;
  }
};

// Kernel 1: the outgoing state's gradient of every chunk, per (head,
// row): dS of the last chunk is dstate (or zero), and dS of chunk z - 1
// is exp(tot_z) dS_z + sum_i exp(cum_i) dy_i c_i^T over chunk z.
template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chain_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     const float* __restrict__ dstate, float* __restrict__ dso,
                     int S, int H, int P, int N, int C, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, row = blockIdx.y;
  const int cp = up16(C), pp = up16(P), nn = up16(N);
  const int ldp = pp + 1, ldn = nn + 1;
  float* ys = smem;                       // [cp][ldp] dy
  float* cs = ys + cp * ldp;              // [cp][ldn] c
  float* dts = cs + cp * ldn;             // [cp] dt
  float* cum = dts + cp;                  // [cp] cumulative log-decay
  float* ecum = cum + cp;                 // [cp] exp(cum)
  const float ah = a[h];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float acc[4][TN];                       // dS: rows p, columns n
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int p = ty + 16 * u, n = tx + 16 * v;
      acc[u][v] = dstate != nullptr && p < P && n < N
          ? dstate[(((size_t)row * H + h) * P + p) * N + n] : 0.f;
    }
  for (int z = nc - 1;; --z) {
    float* out = dso + (((size_t)row * nc + z) * H + h) * P * N;
    each(acc, pp, nn, [&](int p, int n, float v) {
      if (p < P && n < N) out[(size_t)p * N + n] = v;
    });
    if (z == 0) break;
    const Chunk ch(row, z, S, C);
    __syncthreads();                      // the last chunk's tiles are read
    stage_dt(dts, dt, ch.tok0, H, h, ch.rows, ch.rp);
    stage(ys, ldp, dy + (ch.tok0 * H + h) * P, (size_t)H * P, ch.rows,
          ch.rp, P, pp);
    stage(cs, ldn, cm + ch.tok0 * N, N, ch.rows, ch.rp, N, nn);
    __syncthreads();
    chunk_cum(dts, cum, ah, ch.rp);
    __syncthreads();
    for (int i = threadIdx.x; i < ch.rp; i += kThreads)
      ecum[i] = i < ch.rows ? expf(cum[i]) : 0.f;
    __syncthreads();
    const float etot = expf(cum[ch.rows - 1]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] *= etot;
    gemm(acc, pp, nn, ch.rows,
         [&](int p, int i) { return ys[i * ldp + p] * ecum[i]; },
         [&](int i, int n) { return cs[i * ldn + n]; });
  }
}

// Shared memory of kernels 3 and 4, in floats.
__host__ __device__ constexpr int state_floats(int cp, int pp, int nn) {
  return 2 * pp * (nn + 1) + 2 * cp * (pp + 1) + cp * (nn + 1) + cp * 16 +
         6 * cp + kThreads;
}
__host__ __device__ constexpr int intra_floats(int cp, int pp, int nn) {
  return 2 * cp * (pp + 1) + cp * (cp + 1) + cp * ((cp > nn ? cp : nn) + 1) +
         5 * cp;
}

// Kernel 2, per (head, chunk, row): the terms that read S_in or dS.
// Writes dx = u_j dS b_j, ddt = du_j exp(tot - cum_j), the head's db =
// u_j dS^T x_j and dc = exp(cum_i) S_in^T dy_i, and each row's dcum
// (dtot joined to the last row's), for kernel 3 to add to.
template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ dso, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dbp,
                     float* __restrict__ dcp, float* __restrict__ dcum, int S,
                     int H, int P, int N, int C, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, z = blockIdx.y, row = blockIdx.z;
  const int cp = up16(C), pp = up16(P), nn = up16(N);
  const int ldp = pp + 1, ldn = nn + 1;
  const Chunk ch(row, z, S, C);
  const int rows = ch.rows, rp = ch.rp;
  const size_t tok0 = ch.tok0;
  float* ss = smem;                       // [pp][ldn] S_in
  float* sd = ss + pp * ldn;              // [pp][ldn] dS
  float* xs = sd + pp * ldn;              // [cp][ldp] x
  float* ys = xs + cp * ldp;              // [cp][ldp] dy
  float* bc = ys + cp * ldp;              // [cp][ldn] b, then c
  float* part = bc + cp * ldn;            // [cp][16] row partial sums
  float* dts = part + cp * 16;            // [cp] dt
  float* cum = dts + cp;                  // [cp] cumulative log-decay
  float* ecum = cum + cp;                 // [cp] exp(cum)
  float* uu = ecum + cp;                  // [cp] u = exp(tot - cum) dt
  float* du = uu + cp;                    // [cp] x_j . dS b_j
  float* dyy = du + cp;                   // [cp] dy_i . S_in c_i
  float* red = dyy + cp;                  // [kThreads] <dS, S_in> parts
  const int tid = threadIdx.x;
  const float ah = a[h];
  const size_t st0 = (((size_t)row * nc + z) * H + h) * P * N;
  const size_t hp = (size_t)H * P;

  stage_dt(dts, dt, tok0, H, h, rows, rp);
  stage(ss, ldn, states + st0, N, P, pp, N, nn);
  stage(sd, ldn, dso + st0, N, P, pp, N, nn);
  stage(xs, ldp, x + (tok0 * H + h) * P, hp, rows, rp, P, pp);
  stage(ys, ldp, dy + (tok0 * H + h) * P, hp, rows, rp, P, pp);
  stage(bc, ldn, bm + tok0 * N, N, rows, rp, N, nn);
  __syncthreads();
  chunk_cum(dts, cum, ah, rp);
  __syncthreads();
  const float tot = cum[rows - 1];
  for (int i = tid; i < rp; i += kThreads) {
    ecum[i] = i < rows ? expf(cum[i]) : 0.f;
    uu[i] = i < rows ? expf(tot - cum[i]) * dts[i] : 0.f;
  }
  float dot = 0.f;
  for (int e = tid; e < pp * nn; e += kThreads) {
    const int r = e / nn, q = e - r * nn;
    dot = fmaf(sd[r * ldn + q], ss[r * ldn + q], dot);
  }
  red[tid] = dot;
  __syncthreads();

  {  // V = B . dS^T: dx_j = u_j V_j, du_j = x_j . V_j
    float acc[8][4];
    zero(acc);
    gemm(acc, rp, pp, N, [&](int j, int n) { return bc[j * ldn + n]; },
         [&](int n, int p) { return sd[p * ldn + n]; });
    each(acc, rp, pp, [&](int j, int p, float v) {
      if (j < rows && p < P) dx[((tok0 + j) * H + h) * P + p] = uu[j] * v;
    });
    row_parts(acc, rp, pp, part,
              [&](int j, int p) { return xs[j * ldp + p]; });
  }
  {  // X . dS: db_j = u_j (dS^T x_j)
    float acc[8][TN];
    zero(acc);
    gemm(acc, rp, nn, P, [&](int j, int p) { return xs[j * ldp + p]; },
         [&](int p, int n) { return sd[p * ldn + n]; });
    each(acc, rp, nn, [&](int j, int n, float v) {
      if (j < rows && n < N) dbp[((tok0 + j) * H + h) * N + n] = uu[j] * v;
    });
  }
  __syncthreads();                        // b and the du parts are read
  for (int j = tid; j < rp; j += kThreads) du[j] = row_sum(part, j);
  stage(bc, ldn, cm + tok0 * N, N, rows, rp, N, nn);
  __syncthreads();
  {  // Y = C . S_in^T: dy_i . Y_i
    float acc[8][4];
    zero(acc);
    gemm(acc, rp, pp, N, [&](int i, int n) { return bc[i * ldn + n]; },
         [&](int n, int p) { return ss[p * ldn + n]; });
    row_parts(acc, rp, pp, part,
              [&](int i, int p) { return ys[i * ldp + p]; });
  }
  {  // DY . S_in: dc_i = exp(cum_i) (S_in^T dy_i)
    float acc[8][TN];
    zero(acc);
    gemm(acc, rp, nn, P, [&](int i, int p) { return ys[i * ldp + p]; },
         [&](int p, int n) { return ss[p * ldn + n]; });
    each(acc, rp, nn, [&](int i, int n, float v) {
      if (i < rows && n < N) dcp[((tok0 + i) * H + h) * N + n] = ecum[i] * v;
    });
  }
  __syncthreads();                        // the dy . Y parts are written
  for (int i = tid; i < rp; i += kThreads) dyy[i] = row_sum(part, i);
  __syncthreads();
  if (tid == 0) {                         // dtot, in a fixed order
    float d = 0.f;
    for (int t = 0; t < kThreads; ++t) d += red[t];
    float s = expf(tot) * d;
    for (int j = 0; j < rows; ++j) s = fmaf(du[j], uu[j], s);
    red[0] = s;
  }
  __syncthreads();
  for (int i = tid; i < rows; i += kThreads) {
    const size_t k = (tok0 + i) * H + h;
    ddt[k] = du[i] * expf(tot - cum[i]);
    float dc = ecum[i] * dyy[i] - du[i] * uu[i];
    if (i == rows - 1) dc += red[0];
    dcum[k] = dc;
  }
}

// Kernel 3, per (head, chunk, row): the intra term, added to kernel 2's
// dx, db and dc parts, then the reverse cumsum of dcum, ddt, and the
// block's part of da.
template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     const float* __restrict__ cb, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dbp,
                     float* __restrict__ dcp, const float* __restrict__ dcum,
                     float* __restrict__ dap, int S, int H, int P, int N,
                     int C, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, z = blockIdx.y, row = blockIdx.z;
  const int cp = up16(C), pp = up16(P), nn = up16(N);
  const int ldp = pp + 1, ldn = nn + 1, ldc = cp + 1;
  const int ld2 = (cp > nn ? cp : nn) + 1;
  const Chunk ch(row, z, S, C);
  const int rows = ch.rows, rp = ch.rp;
  const size_t tok0 = ch.tok0;
  float* xs = smem;                       // [cp][ldp] x
  float* ys = xs + cp * ldp;              // [cp][ldp] dy
  float* mm = ys + cp * ldp;              // [cp][ldc] dW, then dG
  float* r2 = mm + cp * ldc;              // [cp][ld2] G o L, then b, then c
  float* dts = r2 + cp * ld2;             // [cp] dt
  float* cum = dts + cp;                  // [cp] cumulative log-decay
  float* colr = cum + cp;                 // [cp] sum_i R_ij
  float* rowq = colr + cp;                // [cp] sum_j R_ij dt_j
  float* dsv = rowq + cp;                 // [cp] dcum, then its reverse sum
  const int tid = threadIdx.x;
  const float ah = a[h];
  const size_t hp = (size_t)H * P;

  stage_dt(dts, dt, tok0, H, h, rows, rp);
  stage(xs, ldp, x + (tok0 * H + h) * P, hp, rows, rp, P, pp);
  stage(ys, ldp, dy + (tok0 * H + h) * P, hp, rows, rp, P, pp);
  __syncthreads();
  chunk_cum(dts, cum, ah, rp);
  {  // dW = DY . X^T on and below the diagonal
    float acc[8][8];
    zero(acc);
    gemm(acc, rp, rp, P, [&](int i, int p) { return ys[i * ldp + p]; },
         [&](int p, int j) { return xs[j * ldp + p]; });
    each(acc, rp, rp, [&](int i, int j, float v) {
      mm[i * ldc + j] = j <= i && i < rows ? v : 0.f;
    });
  }
  __syncthreads();                        // cum is written
  const float* g = cb + ((size_t)row * nc + z) * cp * cp;
  for (int e = tid; e < rp * rp; e += kThreads) {   // G o L, selected
    const int i = e / rp, j = e - i * rp;
    r2[i * ld2 + j] = j <= i && i < rows
        ? g[(size_t)i * cp + j] * expf(cum[i] - cum[j]) : 0.f;
  }
  __syncthreads();
  {  // dx_j += dt_j sum_i (G o L)_ij dy_i
    float acc[8][4];
    zero(acc);
    gemm(acc, rp, pp, rows, [&](int j, int i) { return r2[i * ld2 + j]; },
         [&](int i, int p) { return ys[i * ldp + p]; });
    each(acc, rp, pp, [&](int j, int p, float v) {
      if (j < rows && p < P) dx[((tok0 + j) * H + h) * P + p] += dts[j] * v;
    });
  }
  for (int t = tid; t < rp; t += kThreads) {   // R = dW o G o L
    float cs = 0.f, rq = 0.f;
    for (int i = t; i < rows; ++i) cs = fmaf(mm[i * ldc + t], r2[i * ld2 + t],
                                             cs);
    if (t < rows)
      for (int j = 0; j <= t; ++j)
        rq = fmaf(mm[t * ldc + j] * r2[t * ld2 + j], dts[j], rq);
    colr[t] = cs;
    rowq[t] = rq;
  }
  __syncthreads();                        // G o L and dW are read
  for (int e = tid; e < rp * rp; e += kThreads) {   // dG = dW o L o dt
    const int i = e / rp, j = e - i * rp;
    if (j <= i && i < rows)
      mm[i * ldc + j] *= expf(cum[i] - cum[j]) * dts[j];
  }
  stage(r2, ldn, bm + tok0 * N, N, rows, rp, N, nn);
  __syncthreads();
  {  // dc_i += sum_j dG_ij b_j
    float acc[8][TN];
    zero(acc);
    gemm(acc, rp, nn, rows, [&](int i, int j) { return mm[i * ldc + j]; },
         [&](int j, int n) { return r2[j * ldn + n]; });
    each(acc, rp, nn, [&](int i, int n, float v) {
      if (i < rows && n < N) dcp[((tok0 + i) * H + h) * N + n] += v;
    });
  }
  __syncthreads();                        // b is read
  stage(r2, ldn, cm + tok0 * N, N, rows, rp, N, nn);
  __syncthreads();
  {  // db_j += sum_i dG_ij c_i
    float acc[8][TN];
    zero(acc);
    gemm(acc, rp, nn, rows, [&](int j, int i) { return mm[i * ldc + j]; },
         [&](int i, int n) { return r2[i * ldn + n]; });
    each(acc, rp, nn, [&](int j, int n, float v) {
      if (j < rows && n < N) dbp[((tok0 + j) * H + h) * N + n] += v;
    });
  }
  // dcum in full, its reverse cumsum ds; ddt += sum_i R_ij + a ds
  for (int i = tid; i < rows; i += kThreads)
    dsv[i] = dcum[(tok0 + i) * H + h] + rowq[i] - dts[i] * colr[i];
  __syncthreads();
  if (tid == 0) {
    double s = 0.0, da = 0.0;
    for (int i = rows - 1; i >= 0; --i) {
      s += dsv[i];
      dsv[i] = static_cast<float>(s);
      da += s * dts[i];
    }
    dap[((size_t)row * nc + z) * H + h] = static_cast<float>(da);
  }
  __syncthreads();
  for (int i = tid; i < rows; i += kThreads)
    ddt[(tok0 + i) * H + h] += colr[i] + ah * dsv[i];
}

// Kernel 4: db and dc over the heads, da over the rows and chunks.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dbp,
                      const float* __restrict__ dcp,
                      const float* __restrict__ dap, float* __restrict__ db,
                      float* __restrict__ dc, float* __restrict__ da,
                      int tokens, int H, int N, int parts) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t total = (size_t)tokens * N;
  if (e < total) {
    const size_t t = e / N, n = e - t * N;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += dbp[(t * H + h) * N + n];
      sc += dcp[(t * H + h) * N + n];
    }
    db[e] = sb;
    dc[e] = sc;
  } else if (e - total < (size_t)H) {
    const int h = static_cast<int>(e - total);
    double s = 0.0;
    for (int q = 0; q < parts; ++q) s += dap[(size_t)q * H + h];
    da[h] = static_cast<float>(s);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const float *x, *dt, *a, *b, *c, *dy, *states, *cb, *dstate;
  float *dx, *ddt, *da, *db, *dc, *dso, *dbp, *dcp, *dcum, *dap;
  int B, S, H, P, N, C;
};

template <int TN>
cudaError_t launch(const Args& r, cudaStream_t stream) {
  const int cp = up16(r.C), pp = up16(r.P), nn = up16(r.N);
  const int nc = (r.S + r.C - 1) / r.C;
  const size_t f = sizeof(float);
  const size_t smem1 = f * (cp * (pp + 1) + cp * (nn + 1) + 3 * cp);
  const size_t smem2 = f * state_floats(cp, pp, nn);
  const size_t smem3 = f * intra_floats(cp, pp, nn);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_chain_kernel<TN>, smem1)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_state_kernel<TN>, smem2)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_intra_kernel<TN>, smem3)) != cudaSuccess)
    return err;
  ssd_bwd_chain_kernel<TN><<<dim3(r.H, r.B), kThreads, smem1, stream>>>(
      r.dt, r.a, r.c, r.dy, r.dstate, r.dso, r.S, r.H, r.P, r.N, r.C, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_kernel<TN><<<dim3(r.H, nc, r.B), kThreads, smem2, stream>>>(
      r.x, r.dt, r.a, r.b, r.c, r.dy, r.states, r.dso, r.dx, r.ddt, r.dbp,
      r.dcp, r.dcum, r.S, r.H, r.P, r.N, r.C, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_intra_kernel<TN><<<dim3(r.H, nc, r.B), kThreads, smem3, stream>>>(
      r.x, r.dt, r.a, r.b, r.c, r.dy, r.cb, r.dx, r.ddt, r.dbp, r.dcp,
      r.dcum, r.dap, r.S, r.H, r.P, r.N, r.C, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t work = (size_t)r.B * r.S * r.N + r.H;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>((work + kThreads - 1) /
                                                 kThreads),
                          kThreads, 0, stream>>>(
      r.dbp, r.dcp, r.dap, r.db, r.dc, r.da, r.B * r.S, r.H, r.N, r.B * nc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, dy [B, S, H, P]; dt [B, S, H]; a [H]; b, c [B, S, N]; states [B,
// n_chunks, H, P, N] (each chunk's incoming state) and cb [B, n_chunks,
// Cp, Cp] (C_z . B_z^T, lower triangle), both from the forward; dstate
// [B, H, P, N] or null (the final state dropped); outputs dx [B, S, H,
// P], ddt [B, S, H], da [H], db, dc [B, S, N]; f32 scratch: dso [B,
// n_chunks, H, P, N], dbp, dcp [B, S, H, N], dcum [B, S, H], dap [B,
// n_chunks, H]; all f32 and contiguous.  n_chunks = ceil(S / C), C =
// min(chunk, S), Cp = C rounded up to 16.  Takes P <= 64, N <= 128, C
// <= 128.  Launches four kernels on `stream`
// and returns cudaGetLastError() after them.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* dy, const void* states, const void* cb,
    const void* dstate, void* dx, void* ddt, void* da, void* db, void* dc,
    void* dso, void* dbp, void* dcp, void* dcum, void* dap, int B, int S,
    int H, int P, int N, int chunk, void* stream) {
  if (B < 0 || S <= 0 || H < 0 || P <= 0 || N <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const int C = chunk < S ? chunk : S;
  if (P > 64 || N > 128 || C > repro::kMaxChunk) return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const repro::Args r{f(x),      f(dt),  f(a),      f(b),     f(c),
                      f(dy),     f(states), f(cb),  f(dstate), w(dx),
                      w(ddt),    w(da),  w(db),     w(dc),    w(dso),
                      w(dbp),    w(dcp), w(dcum),   w(dap),   B,
                      S,         H,      P,         N,        C};
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 32) return repro::launch<2>(r, s);
  if (N <= 64) return repro::launch<4>(r, s);
  return repro::launch<8>(r, s);
}
