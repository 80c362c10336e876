// The gradient of the Mamba2 SSD chunked scan for Hopper (sm_90a): f32 in
// and out, every product on the tensor cores in 3xTF32.
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
// B and C are one group shared by every head, so the intra terms of db and
// dc are (sum_h dG_h)^T . C and (sum_h dG_h) . B: the heads' dG are summed
// first and multiplied once per (row, chunk), not once per head.
//
// The incoming states: the forward writes them when given a pointer
// ([B, n_chunks, H, P, N] f32, 25 MB a layer at mamba2-780m's B 8, S
// 256), as the flash forwards write their log-sum-exp.  G = C_z . B_z^T is
// the forward's too: its `ssd_cb_kernel` writes the lower triangle into an
// f32 scratch [B, n_chunks, Cp, Cp] (Cp = C rounded up to 16), which the
// caller keeps for the backward beside the states.
//
// One call runs three kernels on the stream:
// 1. `ssd_bwd_chain_kernel`, per (head, row), 8 warps: walks the chunks in
//    reverse with dS in registers ([64, N] in 16 x 8 slices, a set a
//    warp), dS_in = exp(tot) dS + (exp(cum) o DY)^T . C on mma.sync,
//    writing each chunk's dS into a scratch [B, n_chunks, H, P, N] (the
//    sequential axis; 1/n_chunks of the work).
// 2. `ssd_bwd_chunk_kernel`, per (group of heads, chunk, row), 16 warps:
//    the group's heads in order, each staged once by cp.async (x, dy, dt,
//    dS, S_in and c; the next head's copies are issued while this head's
//    rows are finished), cum by a warp-shuffle scan, then on mma.sync:
//    (d) Y = C . S_in^T and dy . S_in c = rowsum(DY o Y) from the
//        accumulators, and <dS, S_in>;
//    (a) b restaged where c was, V = B . dS^T, du = rowsum(X o V) from
//        the accumulators, which are then scaled by u and kept;
//    (b) dW^T = X . DY^T on the tiles on and above its diagonal only (36 of
//        64 at C 128), three or two a warp (tiles w, w + 16, w + 32); from
//        the accumulators W^T = (G o L o dt)^T into shared memory where b
//        was, R's row and column sums into one slot a tile, and dG^T added
//        to the group's sum, which stays in registers across the heads;
//    (c) dx = u o V + W^T . DY over the key tiles from the diagonal on.
//    In (a), (c) and (d) warp w takes row tiles w % 4 and 7 - w % 4, which
//    have 9 key tiles of (c) between them at C 128, and 16 columns of P
//    from 16 (w / 4); the two row tiles share each B fragment.  Then dcum,
//    its reverse cumsum in f64 by one warp's shuffle scan, ddt, the head's
//    part of da, and u and exp(cum) for kernel 3.  At the end the group's
//    dG^T (its upper tiles) goes to a scratch [B, n_chunks, groups, Cp,
//    Cp].
// 3. `ssd_bwd_bc_kernel`, per (row and chunk, db or dc and a slice of up
//    to 64 columns of N, 32 rows of the chunk), 8 warps: db = sum_h (u o
//    X_h) . dS_h + dG^T . C and dc = sum_h (exp(cum) o DY_h) . S_in_h + dG
//    . B, one accumulator each: the heads are the k dimension of the
//    first product, staged head by head through a four-stage cp.async
//    ring, the row scale folded into the A fragments; dG is the groups'
//    partials summed in order as they are staged, and the second product
//    runs over the triangle's key tiles only.  One block also sums da over
//    the rows and chunks.
// No atomics: every partial is written by one block or one warp and summed
// in a fixed order, so two launches give the same bits.  The group size is
// the caller's (`head_group_for` in kernels/ssd_scan/kernel.py: the
// fewest heads a block that leave at most one block an SM).
//
// Instruction: mma.sync m16n8k8 tf32 (HMMA) for every product, in 3xTF32
// (tf32_mma.cuh: hi = tf32(a), lo = tf32(a - hi), lo.hi + hi.lo + hi.hi
// in f32).  One tf32 product misses the backward's hold (2e-4 of each
// output's scale, or no farther from f64 than the plain f32 version) for
// every output at mamba2-780m's and hymba-1.5b's widths, 3xTF32 meets it
// (tests/test_torch_ssd_scan.py emulates both), so every operand is
// split.  mma.sync over wgmma for the forward's reason (ssd_scan.cu):
// wgmma takes tf32 operands K-major only, and X, DY, B and C are read
// down their rows by some products and across them by others.
//
// Shared memory and registers (Cp 128, P padded to 64, N padded to NP):
// kernel 2 holds x and dy [Cp][68], one [Cp][max(NP, Cp) + 4] region for
// c, then b, then W^T, dS and S_in [64][NP + 4], and 33 Cp + 512 floats
// of rows' sums and scales: 218.5 KB at NP 128, 170.5 KB at NP 32, so one
// block an SM, which is why it has 16 warps (128 registers a thread).  Two
// blocks of 8 would need the per-head x, dy, dS, S_in, c or b, and W^T
// under 113 KB each: they are 203 KB at mamba2-780m's widths, and
// restaging any of them for each product adds a staging wait to it.
// Kernel 3: four [32][68] + [64][NB + 8] stages, then the [32][Cp + 4] dG
// rows and the [Cp][NB + 8] key rows in the same region: 106.5 KB at NP
// 128 (NB 64), 74.5 KB at NP 32, two blocks an SM.  Kernel 1: dy [Cp][72]
// and c [Cp][NP + 8], 108 KB at NP 128.  Row strides are 4 (mod 8)
// floats for fragments read along a row and 8 (mod 32) for fragments read
// down a column (W^T . DY's DY reads keep a two-way conflict: DY is read
// across its rows by (b)).
//
// Decay: exp(cum_i - cum_j) is computed only where i >= j (above the
// diagonal it can overflow, and inf * 0 is NaN); a masked entry is set to
// zero, never multiplied by a zero mask, so its gradient is exactly zero.
// G's scratch is read only where i >= j and i is a valid row: the forward
// writes no tile past the last valid row.
//
// Ragged S: as in the forward, the chunk stays C = min(chunk, S) and the
// rows of the last chunk past S are staged with dt = 0 and x = dy = b = c
// = 0; tot is the cumulative decay at the last row before S, and no
// gradient of a row past S is written.  P is padded to 64 and N to 32, 64
// or 128 with zeros, which add nothing.
//
// What bounds it: per (row, chunk, head) the function needs C^2 P
// multiply-adds for dW and dx's intra term on their triangles, 2 C P N
// for dS.b and dS^T.x (none in the last chunk when no final-state gradient
// is given: dS is zero there) and 2 C P N for S_in^T.dy and the chain's
// product (none in the first chunk: S_in is zero there), plus C^2 N once
// per (row, chunk) (G comes from the forward).  At mamba2-780m's training
// call (B 8, S 256, two chunks, no final-state gradient) that is 4.9
// GFLOP, 0.030 ms at 3xTF32's 495 / 3 TFLOP/s, against 106 MB of inputs
// and outputs, 0.032 ms at 3.35 TB/s: the bytes bound it, the operations
// close behind.  The kernel does more than the function needs: (d)'s Y =
// C . S_in^T a head is not needed, since dy_i . (S_in c_i) = c_i .
// (S_in^T dy_i), the row dot with c of dc's inter term; kernel 3 sums
// that term over the heads in its accumulator, so kernel 2 would have to
// form it a head and carry its group's sum, as it carries dG.  Kernels 2
// and 3 also multiply the first chunk's zero S_in and, with no final-state
// gradient, the last chunk's zero dS (kernel 1 stops before the first
// chunk).  Measured on an H100 80GB HBM3 at 700 W at mamba2-780m's
// training call (scripts/ssd_scan_bwd_phases.py; PERF.md, section 6):
// kernel 2 spends 70.7% of a head in its four products ((d) 17.4%, (a)
// 15.9%, (b) 25.4%, (c) 12.0%), whose fragments are loaded from shared
// memory and split in registers (three instructions an element) for every
// mma, 16.4% issuing and waiting for the next head's copies while the
// rows are summed, 4.7% restaging b, the rest in barriers; kernel 3 waits
// on its ring 32% of the time: its blocks read ~300 MB of x, dy, dS and
// S_in slices, 100 MB of them distinct.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_mma.cuh"
#include "tf32_mma.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxChunk = 128;
constexpr int PP = 64;           // P padded: 4 row tiles, 8 column tiles

__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stage `rp` rows of NC columns into shared memory (row stride ld): the
// first `rows` rows and `cols` columns from global memory (row stride gs
// floats), zeros elsewhere.  `vec` (cols, gs and src multiples of 4
// floats): 16-byte cp.async copies, zero-filled past the valid part, left
// in flight for the caller to commit and wait for; else plain loads.
template <int NC, int NTH = kThreads>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t gs, int rows, int rp, int cols,
                                      bool vec) {
  if (vec) {
    constexpr int Q = NC / 4;
    for (int e = threadIdx.x; e < rp * Q; e += NTH) {
      const int r = e / Q, q = (e - r * Q) * 4;
      const bool valid = r < rows && q < cols;
      cp_async16(dst + r * ld + q, valid ? src + r * gs + q : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < rp * NC; e += NTH) {
      const int r = e / NC, q = e - r * NC;
      dst[r * ld + q] = r < rows && q < cols ? __ldg(src + r * gs + q) : 0.f;
    }
  }
}

// Wait for this thread's copies, then for the block.
__device__ __forceinline__ void staged() {
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// 4 bytes from global to shared memory, asynchronously; !valid fills a
// zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// A fragment (16 x 8) at `s` of a row-major tile of stride ld, split.
__device__ __forceinline__ void frag_a(const float* s, int ld, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  tf32_split(s[g * ld + t], hi[0], lo[0]);
  tf32_split(s[(g + 8) * ld + t], hi[1], lo[1]);
  tf32_split(s[g * ld + t + 4], hi[2], lo[2]);
  tf32_split(s[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// B fragment (8 x 8, k by n) at `s` of a tile stored k-rows (s[k][n]).
__device__ __forceinline__ void frag_b_kn(const float* s, int ld, int g,
                                          int t, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  tf32_split(s[t * ld + g], hi[0], lo[0]);
  tf32_split(s[(t + 4) * ld + g], hi[1], lo[1]);
}

// B fragment (8 x 8, k by n) at `s` of a tile stored n-rows (s[n][k]).
__device__ __forceinline__ void frag_b_nk(const float* s, int ld, int g,
                                          int t, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  tf32_split(s[g * ld + t], hi[0], lo[0]);
  tf32_split(s[g * ld + t + 4], hi[1], lo[1]);
}

// Store d0, d1 (adjacent columns) of an accumulator row; the second only
// if `two`, as one 8-byte store if `pair` (both present and aligned).
__device__ __forceinline__ void store2(float* p, float v0, float v1,
                                       bool two, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}

// cum[i] = sum_{t <= i} dt_t a for i < rp, by warp 0's shuffle scan (the
// forward's, so both passes see the same decay).
__device__ __forceinline__ void chunk_cum(const float* dts, float* cum,
                                          float ah, int rp) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < rp; base += 32) {
    const int i = base + lane;
    float v = i < rp ? dts[i] * ah : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (i < rp) cum[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// The geometry of one chunk of one row.
struct Chunk {
  int rows, rp, nrt;   // valid rows, rounded up to 16, 16-row tiles
  size_t tok0;         // token index (row * S + c0) of its first row
  __device__ Chunk(int row, int z, int S, int C) {
    const int c0 = z * C;
    rows = min(C, S - c0);
    rp = up16(rows);
    nrt = rp / 16;
    tok0 = (size_t)row * S + c0;
  }
};

// Kernel 1: the outgoing state's gradient of every chunk, per (head,
// row): dS of the last chunk is dstate (or zero), and dS of chunk z - 1
// is exp(tot_z) dS_z + (exp(cum) o DY_z)^T . C_z.  Warp w holds rows
// p of 16-row tile w % 4 and NTW 8-column tiles from (w / 4) NTW.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chain_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     const float* __restrict__ dstate, float* __restrict__ dso,
                     int S, int H, int P, int N, int C, int nc) {
  constexpr int NTW = NP / 16;
  constexpr int ldy = PP + 8;             // dy rows, read down a column
  constexpr int ldc = NP + 8;             // c rows, B k-rows
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, row = blockIdx.y;
  const int cp = up16(C);
  float* ys = smem;                       // [cp][ldy] dy
  float* cs = ys + cp * ldy;              // [cp][ldc] c
  float* dts = cs + cp * ldc;             // [cp] dt
  float* cum = dts + cp;                  // [cp] cumulative log-decay
  float* ecum = cum + cp;                 // [cp] exp(cum)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4, nb = (warp / 4) * NTW;
  const int p = mt * 16 + g;
  const float ah = a[h];
  const bool cvec = N % 4 == 0 && aligned16(cm);
  const bool yvec = P % 4 == 0 && aligned16(dy);
  const bool spair = N % 2 == 0;

  float st[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pq = p + 8 * (q >> 1), n = (nb + nt) * 8 + 2 * t + (q & 1);
      st[nt][q] = dstate != nullptr && pq < P && n < N
          ? dstate[(((size_t)row * H + h) * P + pq) * N + n] : 0.f;
    }
  for (int z = nc - 1;; --z) {
    float* out = dso + (((size_t)row * nc + z) * H + h) * P * N;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = (nb + nt) * 8 + 2 * t;
      if (n >= N) continue;
      const bool two = n + 1 < N, pair = two && spair;
      if (p < P) store2(out + (size_t)p * N + n, st[nt][0], st[nt][1], two,
                        pair);
      if (p + 8 < P)
        store2(out + (size_t)(p + 8) * N + n, st[nt][2], st[nt][3], two,
               pair);
    }
    if (z == 0) break;
    const Chunk ch(row, z, S, C);
    __syncthreads();                      // the last chunk's tiles are read
    for (int i = tid; i < ch.rp; i += kThreads)
      dts[i] = i < ch.rows ? dt[(ch.tok0 + i) * H + h] : 0.f;
    stage<PP>(ys, ldy, dy + (ch.tok0 * H + h) * P, (size_t)H * P, ch.rows,
              ch.rp, P, yvec);
    stage<NP>(cs, ldc, cm + ch.tok0 * N, N, ch.rows, ch.rp, N, cvec);
    staged();
    chunk_cum(dts, cum, ah, ch.rp);
    __syncthreads();
    for (int i = tid; i < ch.rp; i += kThreads)
      ecum[i] = i < ch.rows ? expf(cum[i]) : 0.f;
    __syncthreads();
    const float etot = expf(cum[ch.rows - 1]);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[nt][q] *= etot;
    for (int k = 0; k < ch.rp; k += 8) {   // A[p][i] = exp(cum_i) dy_i[p]
      const float e0 = ecum[k + t], e1 = ecum[k + t + 4];
      const float* y0 = ys + (k + t) * ldy + p;
      const float* y1 = ys + (k + t + 4) * ldy + p;
      uint32_t ahi[4], alo[4], bh[NTW][2], bl[NTW][2];
      tf32_split(y0[0] * e0, ahi[0], alo[0]);
      tf32_split(y0[8] * e0, ahi[1], alo[1]);
      tf32_split(y1[0] * e1, ahi[2], alo[2]);
      tf32_split(y1[8] * e1, ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        frag_b_kn(cs + k * ldc + (nb + nt) * 8, ldc, g, t, bh[nt], bl[nt]);
      mma_tf32x3(st, ahi, alo, bh, bl);
    }
  }
}

// Kernel 2's block: 16 warps, so that each SM, which holds one block, has
// four warps a scheduler to hide the fragments' load and split latency.
constexpr int kChunkThreads = 512;
constexpr int kMaxTiles = 3;     // dW^T tiles a warp: ceil(36 / 16)

// Shared memory of kernel 2, in floats.
__host__ __device__ constexpr int chunk_floats(int cp, int np) {
  return 2 * cp * (PP + 4) + cp * ((np > cp ? np : cp) + 4) +
         2 * PP * (np + 4) + 33 * cp + kChunkThreads;
}

// The dW^T tiles (jt, it), jt <= it < nrt, in order of jt then it; tile k
// of that list, or false past its end.
__device__ __forceinline__ bool upper_tile(int k, int nrt, int& jt,
                                           int& it) {
  for (jt = 0; jt < nrt; ++jt) {
    if (k < nrt - jt) {
      it = jt + k;
      return true;
    }
    k -= nrt - jt;
  }
  return false;
}

// acc[u] += A[row tile rt_u] . B^T[16 columns from c0] over k < K: A
// row-major (stride lda), B n-rows (stride ldb); B's fragments serve both
// row tiles, whose four accumulators are interleaved.
template <int K>
__device__ __forceinline__ void pair_nk(float (&acc)[2][2][4],
                                        const float* a, int lda,
                                        const float* b, int ldb, int rt0,
                                        int rt1, int c0, int g, int t) {
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      frag_b_nk(b + (c0 + nt * 8) * ldb + k, ldb, g, t, bh[nt], bl[nt]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t ahi[4], alo[4];
      frag_a(a + (u ? rt1 : rt0) * 16 * lda + k, lda, g, t, ahi, alo);
      mma_tf32x3(acc[u], ahi, alo, bh, bl);
    }
  }
}

// acc[u] += A[row tile rt_u][k] . B[k][16 columns from c0] for k in [k0,
// k1) and the tiles u in [U0, U1) (B k-rows, stride ldb).
template <int U0, int U1>
__device__ __forceinline__ void pair_kn(float (&acc)[2][2][4],
                                        const float* a, int lda,
                                        const float* b, int ldb, int rt0,
                                        int rt1, int c0, int k0, int k1,
                                        int g, int t) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      frag_b_kn(b + k * ldb + c0 + nt * 8, ldb, g, t, bh[nt], bl[nt]);
#pragma unroll
    for (int u = U0; u < U1; ++u) {
      uint32_t ahi[4], alo[4];
      frag_a(a + (u ? rt1 : rt0) * 16 * lda + k, lda, g, t, ahi, alo);
      mma_tf32x3(acc[u], ahi, alo, bh, bl);
    }
  }
}

// part[row] = rowsum(S o acc) over the 16 columns from c0, for the rows
// of tile rt (S row-major, stride ld).
__device__ __forceinline__ void row_dot(const float (&acc)[2][4],
                                        const float* s, int ld, int rt,
                                        int c0, float* part, int g, int t) {
  const int i0 = rt * 16 + g;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int pc = c0 + nt * 8 + 2 * t;
    s0 = fmaf(s[i0 * ld + pc], acc[nt][0], s0);
    s0 = fmaf(s[i0 * ld + pc + 1], acc[nt][1], s0);
    s1 = fmaf(s[(i0 + 8) * ld + pc], acc[nt][2], s1);
    s1 = fmaf(s[(i0 + 8) * ld + pc + 1], acc[nt][3], s1);
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  if (t == 0) {
    part[i0] = s0;
    part[i0 + 8] = s1;
  }
}

// Kernel 2, per (group of heads, chunk, row): for each head of the group
// dx, ddt, da's part, u and exp(cum); the group's dG^T at the end.  The
// next head's tiles are staged while this head's rows are finished.
// Warp w: row tiles w % 4 and 7 - w % 4 of (a), (c), (d), 16 columns
// from 16 (w / 4); dW^T tiles w, w + 16, w + 32 of the upper triangle.
template <int NP>
__global__ void __launch_bounds__(kChunkThreads, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ cb,
                     const float* __restrict__ dso, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dgs,
                     float* __restrict__ uus, float* __restrict__ ecs,
                     float* __restrict__ dap, int S, int H, int P, int N,
                     int C, int nc, int group) {
  constexpr int NTH = kChunkThreads;
  constexpr int ldx = PP + 4;             // x, dy rows
  constexpr int ldb = NP + 4;             // b, c rows (A of (a), (d))
  constexpr int ldv = NP + 4;             // dS, S_in [p][n] (B n-rows)
  extern __shared__ __align__(16) float smem[];
  const int grp = blockIdx.x, z = blockIdx.y, row = blockIdx.z;
  const int cp = up16(C), ldw = cp + 4;   // W^T rows
  const Chunk ch(row, z, S, C);
  const int rows = ch.rows, rp = ch.rp, nrt = ch.nrt;
  const size_t tok0 = ch.tok0;
  float* xs = smem;                                   // [cp][ldx] x
  float* ys = xs + cp * ldx;                          // [cp][ldx] dy
  float* mw = ys + cp * ldx;                          // c | b | W^T
  float* vs = mw + cp * ((NP > cp ? NP : cp) + 4);    // [PP][ldv] dS
  float* si = vs + PP * ldv;                          // [PP][ldv] S_in
  float* dtb = si + PP * ldv;             // [2][cp] dt, by head parity
  float* cum = dtb + 2 * cp;              // [cp] cumulative log-decay
  float* ecum = cum + cp;                 // [cp] exp(cum)
  float* uu = ecum + cp;                  // [cp] u = exp(tot - cum) dt
  float* dec = uu + cp;                   // [cp] exp(tot - cum)
  float* du = dec + cp;                   // [cp] x_j . dS b_j
  float* colr = du + cp;                  // [cp] sum_i R_ij
  float* dsv = colr + cp;                 // [cp] dcum, then ds
  float* dupart = dsv + cp;               // [4][cp] du by 16 columns
  float* dyypart = dupart + 4 * cp;       // [4][cp] dy . S_in c by 16
  float* rowpart = dyypart + 4 * cp;      // [8][cp] R's row sums by tile
  float* colpart = rowpart + 8 * cp;      // [8][cp] R dt's column sums
  float* red = colpart + 8 * cp;          // [NTH] <dS, S_in> parts
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t hp = (size_t)H * P;
  const bool xvec = P % 4 == 0 && aligned16(x) && aligned16(dy);
  const bool bvec = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  const bool svec = N % 4 == 0 && aligned16(states) && aligned16(dso);
  const bool xpair = P % 2 == 0;
  const float* gz = cb + ((size_t)row * nc + z) * cp * cp;
  // row tiles of (a), (c), (d): q and 7 - q, which together have 9 key
  // tiles of (c); a tile past the last is computed on the last valid one
  // and not written
  const int q = warp & 3, c0 = (warp >> 2) * 16;
  const int rt0 = min(q, nrt - 1), rt1 = min(7 - q, nrt - 1);
  const bool on0 = q < nrt, on1 = 7 - q < nrt;

  int tj[kMaxTiles], ti[kMaxTiles], ntile = 0;   // this warp's dW^T tiles
#pragma unroll
  for (int m = 0; m < kMaxTiles; ++m)
    if (upper_tile(warp + 16 * m, nrt, tj[m], ti[m])) ntile = m + 1;
  float dgsum[kMaxTiles][2][4];           // the group's dG^T, its tiles
#pragma unroll
  for (int m = 0; m < kMaxTiles; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) dgsum[m][n][r] = 0.f;

  // head h's x, dy, dS, S_in, c (into mw) and dt (into buffer h & 1)
  auto issue = [&](int h) {
    const size_t st0 = (((size_t)row * nc + z) * H + h) * P * N;
    float* dts = dtb + (h & 1) * cp;
    for (int i = tid; i < rp; i += NTH)
      cp_async4(dts + i, dt + (tok0 + min(i, rows - 1)) * H + h, i < rows);
    stage<PP, NTH>(xs, ldx, x + (tok0 * H + h) * P, hp, rows, rp, P, xvec);
    stage<PP, NTH>(ys, ldx, dy + (tok0 * H + h) * P, hp, rows, rp, P, xvec);
    stage<NP, NTH>(vs, ldv, dso + st0, N, P, PP, N, svec);
    stage<NP, NTH>(si, ldv, states + st0, N, P, PP, N, svec);
    stage<NP, NTH>(mw, ldb, cm + tok0 * N, N, rows, rp, N, bvec);
    cp_async_commit();
  };

  const int h0 = grp * group, h1 = min(H, h0 + group);
  if (h0 < h1) issue(h0);
  for (int h = h0; h < h1; ++h) {
    const float ah = a[h];
    const float* dts = dtb + (h & 1) * cp;
    cp_async_wait_all();
    __syncthreads();                      // head h is staged
    chunk_cum(dts, cum, ah, rp);
    __syncthreads();
    const float tot = cum[rows - 1];
    for (int i = tid; i < rp; i += NTH) {
      const float e = i < rows ? expf(tot - cum[i]) : 0.f;
      ecum[i] = i < rows ? expf(cum[i]) : 0.f;
      dec[i] = e;
      uu[i] = e * dts[i];
    }
    __syncthreads();

    // (d) Y = C . S_in^T; dy . S_in c = rowsum(DY o Y); <dS, S_in>
    float acc[2][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][nt][r] = 0.f;
    pair_nk<NP>(acc, mw, ldb, si, ldv, rt0, rt1, c0, g, t);
    float* part = dyypart + (warp >> 2) * cp;
    if (on0) row_dot(acc[0], ys, ldx, rt0, c0, part, g, t);
    if (on1) row_dot(acc[1], ys, ldx, rt1, c0, part, g, t);
    float dot = 0.f;
    for (int e = tid; e < PP * NP; e += NTH) {
      const int r = e / NP, k = e - r * NP;
      dot = fmaf(vs[r * ldv + k], si[r * ldv + k], dot);
    }
    red[tid] = dot;
    __syncthreads();                      // c is read
    stage<NP, NTH>(mw, ldb, bm + tok0 * N, N, rows, rp, N, bvec);
    staged();

    // (a) V = B . dS^T; du = rowsum(X o V); acc = u o V
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][nt][r] = 0.f;
    pair_nk<NP>(acc, mw, ldb, vs, ldv, rt0, rt1, c0, g, t);
    part = dupart + (warp >> 2) * cp;
    if (on0) row_dot(acc[0], xs, ldx, rt0, c0, part, g, t);
    if (on1) row_dot(acc[1], xs, ldx, rt1, c0, part, g, t);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i0 = (u ? rt1 : rt0) * 16 + g;
      const float u0 = uu[i0], u1 = uu[i0 + 8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[u][nt][0] *= u0;
        acc[u][nt][1] *= u0;
        acc[u][nt][2] *= u1;
        acc[u][nt][3] *= u1;
      }
    }
    __syncthreads();                      // b is read

    // (b) dW^T = X . DY^T on this warp's upper tiles; W^T into mw, R's
    // sums into their slots, dG^T into the group's sum
#pragma unroll
    for (int m = 0; m < kMaxTiles; ++m) {
      if (m >= ntile) break;
      const int jt = tj[m], it = ti[m];
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
      for (int k = 0; k < PP; k += 8) {
        uint32_t ahi[4], alo[4], bh[2][2], bl[2][2];
        frag_a(xs + jt * 16 * ldx + k, ldx, g, t, ahi, alo);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          frag_b_nk(ys + (it * 16 + n * 8) * ldx + k, ldx, g, t, bh[n],
                    bl[n]);
        mma_tf32x3(d, ahi, alo, bh, bl);
      }
      float gv[2][4];                     // G at the tile's entries
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = jt * 16 + g + 8 * (r >> 1);
          const int i = it * 16 + n * 8 + 2 * t + (r & 1);
          gv[n][r] = i >= j && i < rows ? __ldg(gz + (size_t)i * cp + j)
                                        : 0.f;
        }
      float rs[2] = {0.f, 0.f}, cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int hh = r >> 1, e = r & 1;
          const int j = jt * 16 + g + 8 * hh;
          const int i = it * 16 + n * 8 + 2 * t + e;
          float w = 0.f, rr = 0.f, dg = 0.f;
          if (i >= j && i < rows) {
            const float l = expf(cum[i] - cum[j]);
            const float gl = gv[n][r] * l;
            w = gl * dts[j];
            rr = d[n][r] * gl;
            dg = d[n][r] * l * dts[j];
          }
          mw[j * ldw + i] = w;
          dgsum[m][n][r] += dg;
          rs[hh] += rr;
          cs[n][e] = fmaf(rr, dts[j], cs[n][e]);
        }
      // row sums over i (lanes of one g), column sums over j (lanes of
      // one t): one slot a tile, summed in order in the finish
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      }
      if (t == 0) {
        rowpart[it * cp + jt * 16 + g] = rs[0];
        rowpart[it * cp + jt * 16 + g + 8] = rs[1];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cs[n][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colpart[jt * cp + it * 16 + n * 8 + 2 * t + e] = v;
        }
    }
    __syncthreads();                      // W^T is written

    // (c) dx = u o V + W^T . DY over the key tiles from the diagonal: the
    // tile whose diagonal comes first alone, then both
    {
      const int s0 = rt0 * 16, s1 = rt1 * 16, sb = max(s0, s1);
      if (s0 < s1)
        pair_kn<0, 1>(acc, mw, ldw, ys, ldx, rt0, rt1, c0, s0, sb, g, t);
      else
        pair_kn<1, 2>(acc, mw, ldw, ys, ldx, rt0, rt1, c0, s1, sb, g, t);
      pair_kn<0, 2>(acc, mw, ldw, ys, ldx, rt0, rt1, c0, sb, rp, g, t);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!(u ? on1 : on0)) continue;
      const int i0 = (u ? rt1 : rt0) * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int pc = c0 + nt * 8 + 2 * t;
        if (pc >= P) continue;
        const bool two = pc + 1 < P, pair = two && xpair;
        float* o = dx + ((tok0 + i0) * H + h) * P + pc;
        if (i0 < rows) store2(o, acc[u][nt][0], acc[u][nt][1], two, pair);
        if (i0 + 8 < rows)
          store2(o + 8 * hp, acc[u][nt][2], acc[u][nt][3], two, pair);
      }
    }
    __syncthreads();                      // x, dy, dS, S_in, W^T are read
    if (h + 1 < h1) issue(h + 1);         // overlaps the finish

    // dcum (without dtot), du and R's row sums, by row
    if (tid < rows) {
      const int i = tid, ri = i >> 4;
      const float dui = dupart[i] + dupart[cp + i] + dupart[2 * cp + i] +
                        dupart[3 * cp + i];
      const float dyy = dyypart[i] + dyypart[cp + i] + dyypart[2 * cp + i] +
                        dyypart[3 * cp + i];
      float cr = 0.f, rq = 0.f;
      for (int k = ri; k < nrt; ++k) cr += rowpart[k * cp + i];
      for (int k = 0; k <= ri; ++k) rq += colpart[k * cp + i];
      dsv[i] = ecum[i] * dyy - dui * uu[i] + rq - dts[i] * cr;
      du[i] = dui;
      colr[i] = cr;
      const size_t k = (tok0 + i) * H + h;
      uus[k] = uu[i];
      ecs[k] = ecum[i];
    }
    __syncthreads();
    if (warp == 0) {
      // dtot = exp(tot) <dS, S_in> + sum_j du_j u_j, by a fixed tree
      constexpr int RW = NTH / 32;
      float dd = 0.f, s = 0.f;
#pragma unroll
      for (int k = 0; k < RW; ++k) dd += red[lane * RW + k];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < rows) s = fmaf(du[i], uu[i], s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dd += __shfl_xor_sync(0xffffffffu, dd, o);
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      const double dtot = (double)(expf(tot) * dd + s);
      // ds = reverse cumsum of dcum in f64 (four rows a lane, then a
      // suffix scan over the lanes); da's part = sum ds dt in f64
      double v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        v[k] = i < rows ? (double)dsv[i] + (i == rows - 1 ? dtot : 0.0) : 0.0;
      }
      v[2] += v[3];
      v[1] += v[2];
      v[0] += v[1];
      double incl = v[0];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += y;
      }
      const double excl = incl - v[0];
      double da = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < rows) {
          const double sv = v[k] + excl;
          dsv[i] = static_cast<float>(sv);
          da += sv * dts[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, o);
      if (lane == 0)
        dap[((size_t)row * nc + z) * H + h] = static_cast<float>(da);
    }
    __syncthreads();
    if (tid < rows)
      ddt[(tok0 + tid) * H + h] =
          du[tid] * dec[tid] + colr[tid] + ah * dsv[tid];
  }

  // the group's dG^T, its upper tiles, [j][i]
  float* out = dgs + (((size_t)row * nc + z) * gridDim.x + grp) * cp * cp;
#pragma unroll
  for (int m = 0; m < kMaxTiles; ++m) {
    if (m >= ntile) break;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = tj[m] * 16 + g + 8 * hh, i = ti[m] * 16 + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)j * cp + i) =
            make_float2(dgsum[m][n][2 * hh], dgsum[m][n][2 * hh + 1]);
      }
  }
}

// Kernel 3's column slice and ring depth.
template <int NP>
struct Bc {
  static constexpr int NB = NP < 64 ? NP : 64;   // columns a block
  static constexpr int NS = NP / NB;             // slices of NP
  static constexpr int NT = NB / 32;             // 8-column tiles a warp
  static constexpr int kStages = 4;
  static constexpr int lda = PP + 4;             // X or DY rows (A)
  static constexpr int ldk = NB + 8;             // B k-rows
  static constexpr int stage = 32 * lda + PP * ldk + 32;
};

// Shared memory of kernel 3, in floats.
template <int NP>
__host__ __device__ constexpr int bc_floats(int cp) {
  return Bc<NP>::kStages * Bc<NP>::stage >
                 32 * (cp + 4) + cp * Bc<NP>::ldk
             ? Bc<NP>::kStages * Bc<NP>::stage
             : 32 * (cp + 4) + cp * Bc<NP>::ldk;
}

// Kernel 3, per (row and chunk, db or dc and a slice of NB columns, 32
// rows): db = sum_h (u o X_h) . dS_h + dG^T . C, or dc = sum_h (exp(cum)
// o DY_h) . S_in_h + dG . B.  Warp w: 16-row tile w & 1, NT 8-column
// tiles from (w >> 1) NT.  Block (0, 0, 0) also sums da.
template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ dy,
                  const float* __restrict__ states,
                  const float* __restrict__ dso,
                  const float* __restrict__ dgs,
                  const float* __restrict__ uus,
                  const float* __restrict__ ecs,
                  const float* __restrict__ dap, float* __restrict__ db,
                  float* __restrict__ dc, float* __restrict__ da, int S,
                  int H, int P, int N, int C, int nc, int ngroups) {
  using K = Bc<NP>;
  constexpr int NT = K::NT, lda = K::lda, ldk = K::ldk;
  extern __shared__ __align__(16) float smem[];
  const int rz = blockIdx.x, r0 = blockIdx.z * 32;
  const int dc_out = blockIdx.y / K::NS;
  const int n0 = (blockIdx.y - dc_out * K::NS) * K::NB;
  const int row = rz / nc, z = rz - row * nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (rz == 0 && blockIdx.y == 0 && r0 == 0)   // da over rows and chunks
    for (int hh = tid; hh < H; hh += kThreads) {
      double s = 0.0;
      for (int q = 0; q < (int)gridDim.x; ++q) s += dap[(size_t)q * H + hh];
      da[hh] = static_cast<float>(s);
    }
  const Chunk ch(row, z, S, C);
  const int rows = ch.rows, rp = ch.rp;
  if (r0 >= rows || n0 >= N) return;
  const int mr = min(32, rows - r0), cp = up16(C), nv = min(K::NB, N - n0);
  const size_t tok0 = ch.tok0 + r0;       // the block's first row
  const float* asrc = dc_out ? dy : x;
  const float* scl = dc_out ? ecs : uus;
  const float* bsrc = dc_out ? states : dso;
  const bool avec = P % 4 == 0 && aligned16(asrc);
  const bool bvec = N % 4 == 0 && aligned16(bsrc);
  const bool kvec = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  const int rt = warp & 1, nb = (warp >> 1) * NT;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
  auto issue = [&](int h) {                // head h into its ring stage
    if (h < H) {
      float* as = smem + (h % K::kStages) * K::stage;
      float* bs = as + 32 * lda;
      float* sc = bs + PP * ldk;
      stage<PP>(as, lda, asrc + (tok0 * H + h) * P, (size_t)H * P, mr, 32,
                P, avec);
      stage<K::NB>(bs, ldk,
                   bsrc + (((size_t)row * nc + z) * H + h) * P * N + n0, N,
                   P, PP, nv, bvec);
      for (int r = tid; r < 32; r += kThreads)
        cp_async4(sc + r, scl + (tok0 + min(r, mr - 1)) * H + h, r < mr);
    }
    cp_async_commit();                     // empty past the last head
  };
#pragma unroll
  for (int s = 0; s < K::kStages - 1; ++s) issue(s);
  for (int h = 0; h < H; ++h) {
    issue(h + K::kStages - 1);
    cp_async_wait<K::kStages - 1>();
    __syncthreads();                      // head h is staged
    const float* as = smem + (h % K::kStages) * K::stage + rt * 16 * lda;
    const float* bs = smem + (h % K::kStages) * K::stage + 32 * lda;
    const float* sc = bs + PP * ldk + rt * 16;
    const float s0 = sc[g], s1 = sc[g + 8];
#pragma unroll 4
    for (int k = 0; k < PP; k += 8) {
      uint32_t ahi[4], alo[4], bh[NT][2], bl[NT][2];
      tf32_split(as[g * lda + k + t] * s0, ahi[0], alo[0]);
      tf32_split(as[(g + 8) * lda + k + t] * s1, ahi[1], alo[1]);
      tf32_split(as[g * lda + k + t + 4] * s0, ahi[2], alo[2]);
      tf32_split(as[(g + 8) * lda + k + t + 4] * s1, ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        frag_b_kn(bs + k * ldk + (nb + nt) * 8, ldk, g, t, bh[nt], bl[nt]);
      mma_tf32x3(acc, ahi, alo, bh, bl);
    }
    __syncthreads();                      // this stage is read
  }
  cp_async_wait<0>();

  // the intra term: dG rows (the groups' partials summed in order) and
  // the key rows of the other matrix, over the triangle's key tiles
  const int ldi = cp + 4;
  float* ai = smem;                       // [32][ldi] A rows
  float* bi = ai + 32 * ldi;              // [cp][ldk] c (db) or b (dc)
  const float* gsrc = dgs + (size_t)rz * ngroups * cp * cp;
  {
    // this thread's entries e = tid + u kThreads of the [32][cp] rows,
    // eight at a time, each summed over the groups in order, the groups'
    // loads of the eight entries in flight together
    constexpr int EPT = 8;
    for (int e0 = 0; e0 < 32 * cp; e0 += EPT * kThreads) {
      float v[EPT];
#pragma unroll
      for (int u = 0; u < EPT; ++u) v[u] = 0.f;
      for (int k = 0; k < ngroups; ++k) {
        const float* gk = gsrc + (size_t)k * cp * cp;
#pragma unroll
        for (int u = 0; u < EPT; ++u) {
          const int e = e0 + tid + u * kThreads;
          const int q = e >> 5, r = e & 31;   // r fastest: coalesced on i
          // dc: dG[i][j] = dG^T[j][i], j <= i; db: dG^T[j][i], i >= j
          const int i = dc_out ? r0 + r : q, j = dc_out ? q : r0 + r;
          if (q < cp && j <= i && i < rows) v[u] += gk[(size_t)j * cp + i];
        }
      }
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const int e = e0 + tid + u * kThreads;
        if ((e >> 5) < cp) ai[(e & 31) * ldi + (e >> 5)] = v[u];
      }
    }
  }
  stage<K::NB>(bi, ldk, (dc_out ? bm : cm) + ch.tok0 * N + n0, N, rows, rp,
               nv, kvec);
  staged();
  {
    const int tile = r0 / 16 + rt;        // this warp's row tile
    const int kb = dc_out ? 0 : tile * 16;
    const int ke = dc_out ? min(rp, (tile + 1) * 16) : rp;
    const float* ar = ai + rt * 16 * ldi;
    for (int k = kb; k < ke; k += 8) {
      uint32_t ahi[4], alo[4], bh[NT][2], bl[NT][2];
      frag_a(ar + k, ldi, g, t, ahi, alo);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        frag_b_kn(bi + k * ldk + (nb + nt) * 8, ldk, g, t, bh[nt], bl[nt]);
      mma_tf32x3(acc, ahi, alo, bh, bl);
    }
  }
  float* out = dc_out ? dc : db;
  const bool pair = N % 2 == 0;
  const int r = rt * 16 + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + (nb + nt) * 8 + 2 * t;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    if (r < mr)
      store2(out + (tok0 + r) * N + n, acc[nt][0], acc[nt][1], two,
             two && pair);
    if (r + 8 < mr)
      store2(out + (tok0 + r + 8) * N + n, acc[nt][2], acc[nt][3], two,
             two && pair);
  }
}

// Allow `bytes` of dynamic shared memory, with the largest carveout.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

struct Args {
  const float *x, *dt, *a, *b, *c, *dy, *states, *cb, *dstate;
  float *dx, *ddt, *da, *db, *dc, *dso, *dgs, *uus, *ecs, *dap;
  int B, S, H, P, N, C, group;
};

template <int NP>
cudaError_t launch(const Args& r, cudaStream_t stream) {
  const int cp = up16(r.C), nc = (r.S + r.C - 1) / r.C;
  const int ng = (r.H + r.group - 1) / r.group;
  const size_t f = sizeof(float);
  const size_t smem1 = f * (cp * (PP + 8) + cp * (NP + 8) + 3 * cp);
  const size_t smem2 = f * chunk_floats(cp, NP);
  const size_t smem3 = f * bc_floats<NP>(cp);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_chain_kernel<NP>, smem1)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_chunk_kernel<NP>, smem2)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_bc_kernel<NP>, smem3)) != cudaSuccess)
    return err;
  ssd_bwd_chain_kernel<NP><<<dim3(r.H, r.B), kThreads, smem1, stream>>>(
      r.dt, r.a, r.c, r.dy, r.dstate, r.dso, r.S, r.H, r.P, r.N, r.C, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<NP><<<dim3(ng, nc, r.B), kChunkThreads, smem2,
                             stream>>>(
      r.x, r.dt, r.a, r.b, r.c, r.dy, r.states, r.cb, r.dso, r.dx, r.ddt,
      r.dgs, r.uus, r.ecs, r.dap, r.S, r.H, r.P, r.N, r.C, nc, r.group);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_bc_kernel<NP><<<dim3(r.B * nc, 2 * Bc<NP>::NS, (cp + 31) / 32),
                          kThreads, smem3, stream>>>(
      r.x, r.b, r.c, r.dy, r.states, r.dso, r.dgs, r.uus, r.ecs, r.dap,
      r.db, r.dc, r.da, r.S, r.H, r.P, r.N, r.C, nc, ng);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, dy [B, S, H, P]; dt [B, S, H]; a [H]; b, c [B, S, N]; states [B,
// n_chunks, H, P, N] (each chunk's incoming state) and cb [B, n_chunks,
// Cp, Cp] (C_z . B_z^T, lower triangle), both from the forward; dstate
// [B, H, P, N] or null (the final state dropped); outputs dx [B, S, H,
// P], ddt [B, S, H], da [H], db, dc [B, S, N]; f32 scratch: dso [B,
// n_chunks, H, P, N], dgs [B, n_chunks, groups, Cp, Cp], uus, ecs [B, S,
// H], dap [B, n_chunks, H]; all f32 and contiguous.  n_chunks = ceil(S /
// C), C = min(chunk, S), Cp = C rounded up to 16, groups = ceil(H /
// group), `group` the heads a block of the chunk kernel takes.  Takes P
// <= 64, N <= 128, C <= 128.  Launches three kernels on `stream` and
// returns cudaGetLastError() after them.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* dy, const void* states, const void* cb,
    const void* dstate, void* dx, void* ddt, void* da, void* db, void* dc,
    void* dso, void* dgs, void* uus, void* ecs, void* dap, int B, int S,
    int H, int P, int N, int chunk, int group, void* stream) {
  if (B < 0 || S <= 0 || H < 0 || P <= 0 || N <= 0 || chunk <= 0 ||
      group <= 0)
    return cudaErrorInvalidValue;
  const int C = chunk < S ? chunk : S;
  if (P > 64 || N > 128 || C > repro::kMaxChunk) return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const repro::Args r{f(x),     f(dt),     f(a),    f(b),      f(c),
                      f(dy),    f(states), f(cb),   f(dstate), w(dx),
                      w(ddt),   w(da),     w(db),   w(dc),     w(dso),
                      w(dgs),   w(uus),    w(ecs),  w(dap),    B,
                      S,        H,         P,       N,         C,
                      group};
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 32) return repro::launch<32>(r, s);
  if (N <= 64) return repro::launch<64>(r, s);
  return repro::launch<128>(r, s);
}
