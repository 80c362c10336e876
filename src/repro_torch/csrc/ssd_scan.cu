// Mamba2 SSD chunked scan for Hopper (sm_90a): f32 in and out, the four
// products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel `ssd_scan_kernel` (body `_kernel`) in
// src/repro/kernels/ssd_scan/kernel.py.  For one (row, head) and a chunk
// of C rows with cumulative log-decay cum_i = sum_{t<=i} dt_t * a:
//
//   G     = C_z . B_z^T                      (shared by every head)
//   intra:  y_i  = sum_{j<=i} G_ij exp(cum_i - cum_j) dt_j x_j
//   inter:  y_i += exp(cum_i) (c_i . state_in^T)
//   state:  state = exp(cum_C) state_in
//                   + sum_j exp(cum_C - cum_j) dt_j x_j b_j^T
//
// One call runs two kernels on the stream:
// 1. `ssd_cb_kernel`: the lower triangle of G = C_z . B_z^T into an f32
//    scratch [B, n_chunks, Cp, Cp] that the caller allocates (Cp = C
//    rounded up to 16; 2.6 MB at B 20, C 128, so it stays in L2), one
//    warp per (16 rows, 32 columns reaching the diagonal, chunk, row),
//    its operands read from L2 straight into the fragments.  G is formed
//    once per (row, chunk), not once per head.
// 2. `ssd_scan_kernel`, one block per (head, slice of Pt of the P
//    columns, row), Pt 64 or 32: y[:, p] and state[p, :] depend only on
//    x[:, p], so a P slice computes nothing twice; the caller takes Pt
//    32 only where 32-wide slices still leave at most one block an SM
//    (B 1 at mamba2-780m's 48 heads), since a 64-wide slice reads G, b
//    and c once for twice the work.  The block walks the chunks in order
//    with its [Pt, N] state in registers (the chunk axis is the TPU
//    grid's sequential axis).  Per chunk: (a) y = C . state^T, each row
//    scaled by exp(cum_i) (skipped, and c not staged, for the first
//    chunk, whose state is zero); (b) y += W . X, W = G o exp(cum_i -
//    cum_j) o dt_j formed once from the scratch in shared memory, over
//    key tiles up to the diagonal, then y to global memory from
//    registers; (c) state =
//    exp(tot) state + (X o dt exp(tot - cum))^T . B: the state
//    accumulator is scaled, then accumulated into.  8 warps: y in 16-row
//    tiles, warp w taking tile w of the first half of the columns and
//    tile 7 - w of the second, so the triangle's work is even across
//    warps; the state in 16 x 8 NTW slices, one a warp.
//
// Instruction: mma.sync m16n8k8 tf32 (HMMA) for every product, in 3xTF32
// (tf32_mma.cuh: hi = tf32(a), lo = tf32(a - hi), lo.hi + hi.lo + hi.hi
// in f32).  One tf32 product alone misses the 2e-4-of-scale tolerance
// against the f32 chunked version at mamba2-780m's widths, 3xTF32 meets
// it (tests/test_torch_ssd_scan.py emulates both), so every operand is
// split.
// mma.sync over wgmma because wgmma takes tf32 operands from shared
// memory K-major only: X and B would have to be staged transposed, and
// hi and lo twice over.  mma.sync reads each operand from shared memory
// once, in whichever layout it was staged, and splits it in registers.
//
// Shared memory (at Pt 64, N 128, C 128, 108.5 KB, two blocks an SM): one
// [C, N + 8] region holds c, then W, then b; one region holds the state
// (for (a)), then x; plus cum, dt, exp(cum) and dt exp(tot - cum).  Row
// strides are 4 (mod 8) floats for fragments read along a row and 8
// (mod 32) for fragments read down a column, so no fragment load has a
// bank conflict.  Tiles are staged by 16-byte cp.async (plain loads where
// a width is not a multiple of 4), zero-filled past the valid part.
//
// Decay: exp(cum_i - cum_j) is computed only where i >= j.  Above the
// diagonal the exponent is positive and can overflow, and inf * 0 is NaN,
// so a masked term is set to zero, never multiplied by a zero mask.
// expf, not __expf, so the decay keeps full f32 precision.
//
// Ragged S: the chunk stays and the rows of the last chunk past S are
// staged with dt = 0, x = b = c = 0: such a row adds nothing to the state
// and leaves its decay at 1, and its y is never written.  Tiles wholly
// past the last valid row are skipped.  N is padded to 32, 64 or 128 and
// P to the slice with zeros, which add nothing.
//
// What bounds it: per (row, chunk) of C rows the function does C^2 N
// (G, once) + H (C^2 P + 4 C P N) operations, 508 MFLOP a row at
// mamba2-780m's shapes, against 8.2 MB of x, y, dt, b, c and state: ~62
// operations a byte, so the 3xTF32 products (three tensor-core products
// for each) bound it, at 495 / 3 TFLOP/s on an H100, not the bytes.  The
// kernel runs at ~6x that bound: the three staging waits and the W pass
// of each chunk (about 40% of a block's time at B 20,
// scripts/ssd_scan_phases.py) overlap only with the other block on the
// SM, and splitting each operand in registers costs three instructions
// for every element of every fragment.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_mma.cuh"
#include "tf32_mma.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxChunk = 128;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stage `rp` rows of NC columns into shared memory (row stride ld): the
// first `rows` rows and `cols` columns from global memory (row stride gs
// floats), zeros elsewhere.  `vec` (cols, gs and src multiples of 4
// floats): 16-byte cp.async copies, zero-filled past the valid part, left
// in flight for the caller to commit and wait for; else plain loads.
template <int NC>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t gs, int rows, int rp, int cols,
                                      bool vec) {
  if (vec) {
    constexpr int Q = NC / 4;
    for (int e = threadIdx.x; e < rp * Q; e += kThreads) {
      const int r = e / Q, q = (e - r * Q) * 4;
      const bool valid = r < rows && q < cols;
      cp_async16(dst + r * ld + q, valid ? src + r * gs + q : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < rp * NC; e += kThreads) {
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

// Kernel 1: G = C_z . B_z^T on and below the diagonal.  One warp per
// item (16-row tile rt, 32 columns jg reaching the diagonal, chunk z,
// row): a chunk is a few KB of b and c, read from L2 straight into the
// fragments, and even B 1 spreads over 40 warps.  The item's four
// 8-column tiles are four accumulators; a tile past the diagonal reads
// and writes nothing.
__host__ __device__ constexpr int cb_items(int nrt) {
  return (nrt / 2) * (nrt / 2 + 1) + (nrt % 2) * (nrt + 1) / 2;
}

template <int NP>
__global__ void __launch_bounds__(32)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, int S, int N, int C, int nc) {
  const int z = blockIdx.y, row = blockIdx.z;
  int rt = 0, jg = blockIdx.x;                 // row tile rt has
  while (jg >= rt / 2 + 1) jg -= rt++ / 2 + 1;  // rt / 2 + 1 items
  const int cp = round16(C), c0 = z * C, rows = min(C, S - c0);
  if (rt * 16 >= rows) return;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int ntv = min(4, 2 * rt + 2 - 4 * jg);  // tiles to the diagonal
  const float* cz = cm + ((size_t)row * S + c0) * N;
  const float* bz = bm + ((size_t)row * S + c0) * N;
  auto at = [&](const float* m, int r, int k) {
    return r < rows && k < N ? __ldg(m + (size_t)r * N + k) : 0.f;
  };
  const int r = rt * 16 + g;
  float d[4][4] = {};
#pragma unroll 4
  for (int k = 0; k < NP; k += 8) {
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    tf32_split(at(cz, r, k + t), ah[0], al[0]);
    tf32_split(at(cz, r + 8, k + t), ah[1], al[1]);
    tf32_split(at(cz, r, k + t + 4), ah[2], al[2]);
    tf32_split(at(cz, r + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = jg * 32 + n * 8 + g;
      const bool on = n < ntv;
      tf32_split(on ? at(bz, j, k + t) : 0.f, bh[n][0], bl[n][0]);
      tf32_split(on ? at(bz, j, k + t + 4) : 0.f, bh[n][1], bl[n][1]);
    }
    mma_tf32x3(d, ah, al, bh, bl);
  }
  float* out = cb + (((size_t)row * nc + z) * cp + r) * cp + jg * 32 + 2 * t;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (n >= ntv) continue;
    *reinterpret_cast<float2*>(out + n * 8) = make_float2(d[n][0], d[n][1]);
    *reinterpret_cast<float2*>(out + 8 * cp + n * 8) =
        make_float2(d[n][2], d[n][3]);
  }
}

// Shared memory of the scan kernel, in floats.
__host__ __device__ constexpr int scan_big(int cp, int np) {
  return cp * (np + 8 > cp + 4 ? np + 8 : cp + 4);
}
__host__ __device__ constexpr int scan_r1(int cp, int pt, int np) {
  return pt * (np + 4) > cp * (pt + 8) ? pt * (np + 4) : cp * (pt + 8);
}

// Kernel 2: one block per (head, P slice of PT columns, row).
template <int PT, int NP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ cb,
                float* __restrict__ y, float* __restrict__ state_out,
                float* __restrict__ states, int S, int H, int P, int N, int C,
                int nc) {
  constexpr int NTU = PT / 16;            // 8-column tiles of a y unit
  constexpr int MT = PT / 16;             // 16-row tiles of the state (p)
  constexpr int NTW = NP * PT / 1024;     // 8-column state tiles a warp
  constexpr int ldc = NP + 4;             // c rows, A of (a)
  constexpr int lds = NP + 4;             // state [p][n], B of (a)
  constexpr int ldb = NP + 8;             // b rows, B of (c)
  constexpr int ldx = PT + 8;             // x rows, B of (b), A of (c)
  extern __shared__ __align__(16) float smem[];
  const int cp = round16(C), ldw = cp + 4;
  float* big = smem;                          // c | W [cp][ldw] | b
  float* r1 = big + scan_big(cp, NP);         // state [PT][lds] | x
  float* cum = r1 + scan_r1(cp, PT, NP);      // [cp] cumulative log-decay
  float* dts = cum + cp;                      // [cp] dt
  float* ecum = dts + cp;                     // [cp] exp(cum)
  float* dec = ecum + cp;                     // [cp] dt exp(tot - cum)

  const int h = blockIdx.x, p0 = blockIdx.y * PT, row = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pc = min(PT, P - p0);             // valid columns of the slice
  const float ah = a[h];
  const bool bvec = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  const bool xvec = P % 4 == 0 && pc % 4 == 0 && aligned16(x);
  const bool ypair = P % 2 == 0;
  const bool spair = N % 2 == 0;
  const int mt = warp % MT, nb = (warp / MT) * NTW;

  float st[NTW][4];                            // this warp's state slice
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) st[nt][q] = 0.f;
  float yacc[2][NTU][4];
  // this warp's state slice from registers into so [P, N] (the block's
  // rows p0 + p)
  auto put = [&](float* so) {
    const int p = mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = (nb + nt) * 8 + 2 * t;
      if (n >= N) continue;
      const bool two = n + 1 < N, pair = two && spair;
      if (p < pc) store2(so + (size_t)(p0 + p) * N + n, st[nt][0], st[nt][1],
                         two, pair);
      if (p + 8 < pc)
        store2(so + (size_t)(p0 + p + 8) * N + n, st[nt][2], st[nt][3], two,
               pair);
    }
  };

  for (int z = 0; z < nc; ++z) {
    const int c0 = z * C, rows = min(C, S - c0);
    const int nrt = (rows + 15) >> 4, rp = nrt * 16;
    const size_t tok0 = (size_t)row * S + c0;
    if (states != nullptr)                     // the chunk's incoming state
      put(states + (((size_t)row * nc + z) * H + h) * P * N);
    __syncthreads();                           // the last chunk is done
    for (int i = tid; i < rp; i += kThreads)
      dts[i] = i < rows ? dt[(tok0 + i) * H + h] : 0.f;
    if (z > 0) {                               // c and state_in, for (a)
      stage<NP>(big, ldc, cm + tok0 * N, N, rows, rp, N, bvec);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        float* s = r1 + (mt * 16 + g) * lds + (nb + nt) * 8 + 2 * t;
        s[0] = st[nt][0];
        s[1] = st[nt][1];
        s[8 * lds] = st[nt][2];
        s[8 * lds + 1] = st[nt][3];
      }
    }
    staged();
    if (warp == 0) {                           // one warp scans dt * a
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
    __syncthreads();
    const float tot = cum[rows - 1];
    for (int i = tid; i < rp; i += kThreads) {
      ecum[i] = expf(cum[i]);
      dec[i] = dts[i] * expf(tot - cum[i]);
    }

    // (a) y = C . state_in^T
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rt = u ? 7 - warp : warp;
#pragma unroll
      for (int nt = 0; nt < NTU; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[u][nt][q] = 0.f;
      if (rt >= nrt) continue;
      if (z == 0) continue;                    // state_in is zero
      const float* ar = big + rt * 16 * ldc;
      const float* br = r1 + u * (PT / 2) * lds;
#pragma unroll 2
      for (int k = 0; k < NP; k += 8) {
        uint32_t ahi[4], alo[4], bh[NTU][2], bl[NTU][2];
        frag_a(ar + k, ldc, g, t, ahi, alo);
#pragma unroll
        for (int nt = 0; nt < NTU; ++nt)
          frag_b_nk(br + nt * 8 * lds + k, lds, g, t, bh[nt], bl[nt]);
        mma_tf32x3(yacc[u], ahi, alo, bh, bl);
      }
    }
    __syncthreads();                           // c and state_in are read

    // stage x, and G (on and below the diagonal) where W will be
    stage<PT>(r1, ldx, x + (tok0 * H + h) * P + p0, (size_t)H * P, rows, rp,
              pc, xvec);
    const float* gz = cb + ((size_t)row * nc + z) * cp * cp;
    const int q4 = rp / 4;
    for (int e = tid; e < rp * q4; e += kThreads) {
      const int i = e / q4, j0 = (e - i * q4) * 4;
      const bool valid = i < rows && j0 <= i;
      cp_async16(big + i * ldw + j0, valid ? gz + i * cp + j0 : gz, valid);
    }
    staged();
    // W = G o exp(cum_i - cum_j) o dt_j, zero where j > i, four columns
    // a thread (16-byte shared-memory accesses: no bank conflicts), over
    // the lower triangle only: rows i and rp - 1 - i together hold q4 + 1
    // groups of four
    for (int e = tid; e < (rp / 2) * (q4 + 1); e += kThreads) {
      const int pr = e / (q4 + 1), k = e - pr * (q4 + 1);
      const bool lo = k <= pr / 4;
      const int i = lo ? pr : rp - 1 - pr;
      const int j0 = 4 * (lo ? k : k - pr / 4 - 1);
      if (i >= rows) continue;                // zero-filled already
      float4* wp = reinterpret_cast<float4*>(big + i * ldw + j0);
      const float4 gv = *wp;
      const float4 dj = *reinterpret_cast<const float4*>(dts + j0);
      const float4 cj = *reinterpret_cast<const float4*>(cum + j0);
      const float ci = cum[i];
      float4 w;
      w.x = gv.x * expf(ci - cj.x) * dj.x;    // j0 <= i
      w.y = j0 + 1 <= i ? gv.y * expf(ci - cj.y) * dj.y : 0.f;
      w.z = j0 + 2 <= i ? gv.z * expf(ci - cj.z) * dj.z : 0.f;
      w.w = j0 + 3 <= i ? gv.w * expf(ci - cj.w) * dj.w : 0.f;
      *wp = w;
    }
    __syncthreads();

    // (b) y = exp(cum_i) y + W . X, then y to global memory
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rt = u ? 7 - warp : warp;
      if (rt >= nrt) continue;
      const int i = rt * 16 + g;
      const float e0 = ecum[i], e1 = ecum[i + 8];
#pragma unroll
      for (int nt = 0; nt < NTU; ++nt) {
        yacc[u][nt][0] *= e0;
        yacc[u][nt][1] *= e0;
        yacc[u][nt][2] *= e1;
        yacc[u][nt][3] *= e1;
      }
      const float* ar = big + rt * 16 * ldw;
      const float* br = r1 + u * (PT / 2);
      for (int k0 = 0; k0 <= rt * 16; k0 += 16) {   // key tiles to the
#pragma unroll                                       // diagonal, 2 k-steps
        for (int k = k0; k < k0 + 16; k += 8) {      // each
          uint32_t ahi[4], alo[4], bh[NTU][2], bl[NTU][2];
          frag_a(ar + k, ldw, g, t, ahi, alo);
#pragma unroll
          for (int nt = 0; nt < NTU; ++nt)
            frag_b_kn(br + k * ldx + nt * 8, ldx, g, t, bh[nt], bl[nt]);
          mma_tf32x3(yacc[u], ahi, alo, bh, bl);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTU; ++nt) {
        const int p = u * (PT / 2) + nt * 8 + 2 * t;
        if (p >= pc) continue;
        const bool two = p + 1 < pc, pair = two && ypair;
        float* yp = y + ((tok0 + i) * H + h) * P + p0 + p;
        if (i < rows)
          store2(yp, yacc[u][nt][0], yacc[u][nt][1], two, pair);
        if (i + 8 < rows)
          store2(yp + 8 * (size_t)H * P, yacc[u][nt][2], yacc[u][nt][3],
                 two, pair);
      }
    }
    __syncthreads();                           // W is read
    stage<NP>(big, ldb, bm + tok0 * N, N, rows, rp, N, bvec);
    staged();

    // (c) state = exp(tot) state + (X o dt exp(tot - cum))^T . B
    const float etot = expf(tot);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[nt][q] *= etot;
    const float* xa = r1 + mt * 16;
    for (int k = 0; k < rp; k += 8) {
      const float d0 = dec[k + t], d1 = dec[k + t + 4];
      uint32_t ahi[4], alo[4], bh[NTW][2], bl[NTW][2];
      tf32_split(xa[(k + t) * ldx + g] * d0, ahi[0], alo[0]);
      tf32_split(xa[(k + t) * ldx + g + 8] * d0, ahi[1], alo[1]);
      tf32_split(xa[(k + t + 4) * ldx + g] * d1, ahi[2], alo[2]);
      tf32_split(xa[(k + t + 4) * ldx + g + 8] * d1, ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        frag_b_kn(big + k * ldb + (nb + nt) * 8, ldb, g, t, bh[nt], bl[nt]);
      mma_tf32x3(st, ahi, alo, bh, bl);
    }
  }

  put(state_out + ((size_t)row * H + h) * P * N);   // the final state
}

// Allow `bytes` of dynamic shared memory, and ask for the largest
// carveout so that two scan blocks fit on an SM.
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

template <int PT, int NP>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* b, const float* c, float* cb, float* y,
                   float* state, float* states, int B, int S, int H, int P,
                   int N, int C, cudaStream_t stream) {
  const int cp = round16(C), nc = (S + C - 1) / C;
  ssd_cb_kernel<NP><<<dim3(cb_items(cp / 16), nc, B), 32, 0, stream>>>(
      b, c, cb, S, N, C, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 =
      sizeof(float) * (scan_big(cp, NP) + scan_r1(cp, PT, NP) + 4 * cp);
  err = allow_smem(ssd_scan_kernel<PT, NP>, smem2);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<PT, NP><<<dim3(H, (P + PT - 1) / PT, B), kThreads, smem2,
                            stream>>>(x, dt, a, b, c, cb, y, state, states,
                                      S, H, P, N, C, nc);
  return cudaGetLastError();
}

template <int PT>
cudaError_t launch_pt(const float* x, const float* dt, const float* a,
                      const float* b, const float* c, float* cb, float* y,
                      float* state, float* states, int B, int S, int H, int P,
                      int N, int C, cudaStream_t stream) {
  if (N <= 32)
    return launch<PT, 32>(x, dt, a, b, c, cb, y, state, states, B, S, H, P,
                          N, C, stream);
  if (N <= 64)
    return launch<PT, 64>(x, dt, a, b, c, cb, y, state, states, B, S, H, P,
                          N, C, stream);
  return launch<PT, 128>(x, dt, a, b, c, cb, y, state, states, B, S, H, P,
                         N, C, stream);
}

}  // namespace
}  // namespace repro

// x [B, S, H, P]; dt [B, S, H]; a [H]; b, c [B, S, N]; y [B, S, H, P];
// state [B, H, P, N]; `states`, if not null, [B, ceil(S / C), H, P, N]
// receives each chunk's incoming state (zero for the first), for the
// backward (ssd_scan_bwd.cu): all f32 and contiguous.  `chunk` is the scan's
// chunk length (C = min(chunk, S); the tail of a ragged last chunk is
// masked).  `cb` is f32 scratch of B * ceil(S / C) * Cp * Cp floats, Cp =
// C rounded up to 16, for C_z . B_z^T.  `p_tile` (32 or 64) is the P
// slice of a scan block.  Takes P <= 64, N <= 128, C <= 128.  Launches
// both kernels on `stream` and returns cudaGetLastError() after them.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, void* y,
                              void* state, void* states, void* cb, int B,
                              int S, int H, int P, int N, int chunk,
                              int p_tile, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (B < 0 || S <= 0 || H < 0 || P <= 0 || N <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const int C = chunk < S ? chunk : S;
  if (P > 64 || N > 128 || C > repro::kMaxChunk ||
      (p_tile != 32 && p_tile != 64))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  float* cbf = static_cast<float*>(cb);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  float* cs = static_cast<float*>(states);
  if (p_tile == 32)
    return repro::launch_pt<32>(f(x), f(dt), f(a), f(b), f(c), cbf, yf, sf,
                                cs, B, S, H, P, N, C, s);
  return repro::launch_pt<64>(f(x), f(dt), f(a), f(b), f(c), cbf, yf, sf,
                              cs, B, S, H, P, N, C, s);
}
