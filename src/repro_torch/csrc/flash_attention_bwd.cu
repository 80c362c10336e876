// The gradient of dense GQA prefill attention for Hopper (sm_90a), in f32:
// dQ, dK and dV of out = softmax(scale * Q.K^T, masked) . V for every mode
// the forward kernel (flash_attention.cu) takes: causal, sliding window,
// and full mode with Sq != Sk and a key bound kv_len.
//
// Replaces no TPU kernel: the JAX package differentiates its plain jnp
// attention and has no backward Pallas kernel.  The port's forward is a
// hand-written kernel reached through ctypes, which autograd cannot see
// through, so its gradient is a kernel too (ops.py wraps the pair in a
// torch.autograd.Function).
//
// Algorithm: the FlashAttention-2 backward.  The forward stores each query
// row's log-sum-exp lse of its scaled scores, so a tile recomputes its
// probabilities as P = exp(scale * q.k - lse) without a softmax pass.
// With delta = rowsum(dO o O), dP = dO . V^T and dS = P o (dP - delta):
//   dV = P^T . dO,   dK = scale * dS^T . Q,   dQ = scale * dS . K.
// Two kernels a call, on one stream:
//   flash_bwd_dq_kernel: one block per (row, KV head, 64 packed query
//     rows), the forward's tiling; it loops over the key tiles its rows
//     can see, accumulates dQ in shared memory and writes it once, and
//     writes its rows' delta to a scratch [B, Sq, Hq] for the next kernel.
//   flash_bwd_dkdv_kernel: one block per (row, KV head, 32 keys); it loops
//     over the packed query rows that can see its keys, accumulates dK and
//     dV in shared memory and writes them once.  Rows are packed as the
//     forward packs them (row r of the Sq * G rows of a KV head is position
//     r / G, query head h * G + r % G), so the sum over the G query heads
//     of a group is the loop over rows itself: no atomics.
// Both recompute P; neither reads a key at or past kv_len (staged as zeros,
// so NaN there cannot reach a product) and those keys get dK = dV = 0.
//
// What bounds it: at smollm-135m's training shapes (S 256, D 64, causal)
// the five products of a tile pair (S, dP, dV, dK, and dQ in the other
// kernel) are bound by operations; as the f32 forward, it computes on the
// CUDA cores out of shared memory (rows padded to D + 1 floats so both
// row and column walks are free of bank conflicts) and is bound by
// shared-memory loads.  f32 only: the trainer runs f32, as the JAX
// package's does; a bf16 tensor-core backward is later work.
#include <cmath>

#include "attention_common.cuh"

namespace repro {
namespace {

constexpr int kBwdThreads = 256;
constexpr int kDqRows = 64;    // packed query rows per dQ block
constexpr int kDqKeys = 32;    // keys staged per dQ step
constexpr int kKvKeys = 32;    // keys per dK/dV block
constexpr int kKvRows = 32;    // packed query rows staged per dK/dV step
constexpr size_t kMaxSmem = 227 * 1024;

// A key at kp is visible to a query at qp under the call's mask.
__device__ __forceinline__ bool visible(int qp, int kp, int kv_len,
                                        int causal, int window) {
  return kp < kv_len && (!causal || kp <= qp) &&
         (window <= 0 || qp - kp < window);
}

__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv,
                    int D, int causal, int window, int kv_len, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, ld = D + 1;
  const int r0 = blockIdx.x * kDqRows;
  const int R = min(kDqRows, Sq * G - r0);
  float* qs = smem;                      // [TR][ld] scaled queries
  float* dos = qs + kDqRows * ld;        // [TR][ld] dO
  float* ks = dos + kDqRows * ld;        // [TK][ld] staged K tile
  float* vs = ks + kDqKeys * ld;         // [TK][ld] staged V tile
  float* dss = vs + kDqKeys * ld;        // [TR][TK] dS
  float* acc = dss + kDqRows * kDqKeys;  // [TR][D]  dQ / scale
  float* ls = acc + kDqRows * D;         // [TR]     lse
  float* ds = ls + kDqRows;              // [TR]     delta

  // row index of packed row r in [B, Sq, Hq] (times D: its element offset)
  auto qrow = [&](int r) {
    const int row = r0 + r;
    return ((size_t)b * Sq + row / G) * Hq + (size_t)h * G + row % G;
  };
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const size_t off = qrow(r) * D + d;
    qs[r * ld + d] = q[off] * scale;
    dos[r * ld + d] = dout[off];
    acc[e] = dout[off] * o[off];  // delta's terms, summed below
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float sum = 0.f;
    for (int d = 0; d < D; ++d) sum += acc[r * D + d];
    ds[r] = sum;
    ls[r] = lse[qrow(r)];
    delta[qrow(r)] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) acc[e] = 0.f;

  // keys any row of this tile can see: [k_lo, k_hi), as in the forward
  const int p_lo = r0 / G, p_hi = (r0 + R - 1) / G;
  const int k_hi = causal ? min(kv_len, p_hi + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  for (int c0 = k_lo; c0 < k_hi; c0 += kDqKeys) {
    __syncthreads();  // the previous tile is consumed
    auto row_off = [&](int t) {
      return (((size_t)b * Sk + c0 + t) * Hkv + h) * D;
    };
    auto ok = [&](int t) { return c0 + t < k_hi; };
    stage_rows(ks, ld, k, kDqKeys, D, row_off, ok);
    stage_rows(vs, ld, v, kDqKeys, D, row_off, ok);
    __syncthreads();
    for (int e = threadIdx.x; e < R * kDqKeys; e += blockDim.x) {
      const int r = e / kDqKeys, t = e - r * kDqKeys;
      float dsv = 0.f;
      if (visible((r0 + r) / G, c0 + t, k_hi, causal, window)) {
        const float* qa = qs + r * ld;
        const float* da = dos + r * ld;
        const float* kb = ks + t * ld;
        const float* vb = vs + t * ld;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qa[d], kb[d], s);
          dp = fmaf(da[d], vb[d], dp);
        }
        dsv = expf(s - ls[r]) * (dp - ds[r]);
      }
      dss[e] = dsv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
      const int r = e / D, d = e - r * D;
      const float* dsr = dss + r * kDqKeys;
      float a = acc[e];
      for (int t = 0; t < kDqKeys; ++t) a = fmaf(dsr[t], ks[t * ld + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    dq[qrow(r) * D + d] = acc[e] * scale;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                      int D, int causal, int window, int kv_len,
                      float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, ld = D + 1;
  const int c0 = blockIdx.x * kKvKeys;
  const int T = min(kKvKeys, Sk - c0);  // keys of this block that exist
  float* ks = smem;                      // [TK][ld] K
  float* vs = ks + kKvKeys * ld;         // [TK][ld] V
  float* qs = vs + kKvKeys * ld;         // [TR][ld] scaled queries
  float* dos = qs + kKvRows * ld;        // [TR][ld] dO
  float* ps = dos + kKvRows * ld;        // [TR][TK] P
  float* dss = ps + kKvRows * kKvKeys;   // [TR][TK] dS
  float* dka = dss + kKvRows * kKvKeys;  // [TK][D]  dK
  float* dva = dka + kKvKeys * D;        // [TK][D]  dV
  float* ls = dva + kKvKeys * D;         // [TR]     lse
  float* dls = ls + kKvRows;             // [TR]     delta

  auto kv_off = [&](int t) { return (((size_t)b * Sk + c0 + t) * Hkv + h) * D; };
  // keys past kv_len are staged as zeros and never visible
  const int k_end = min(c0 + T, kv_len);
  stage_rows(ks, ld, k, kKvKeys, D, kv_off, [&](int t) { return c0 + t < k_end; });
  stage_rows(vs, ld, v, kKvKeys, D, kv_off, [&](int t) { return c0 + t < k_end; });
  for (int e = threadIdx.x; e < kKvKeys * D; e += blockDim.x) {
    dka[e] = 0.f;
    dva[e] = 0.f;
  }

  // query positions that can see some key of [c0, k_end): [q_lo, q_hi)
  int q_lo = 0, q_hi = 0;
  if (k_end > c0) {
    q_lo = causal ? c0 : 0;
    q_hi = window > 0 ? min(Sq, k_end - 1 + window) : Sq;
  }
  auto qrow = [&](int row) {  // packed row -> row index in [B, Sq, Hq]
    return ((size_t)b * Sq + row / G) * Hq + (size_t)h * G + row % G;
  };
  for (int p0 = q_lo * G; p0 < q_hi * G; p0 += kKvRows) {
    const int R = min(kKvRows, q_hi * G - p0);
    __syncthreads();  // the previous rows are consumed
    for (int e = threadIdx.x; e < kKvRows * D; e += blockDim.x) {
      const int r = e / D, d = e - r * D;
      float qv = 0.f, dov = 0.f;
      if (r < R) {
        const size_t off = qrow(p0 + r) * D + d;
        qv = q[off] * scale;
        dov = dout[off];
      }
      qs[r * ld + d] = qv;
      dos[r * ld + d] = dov;
    }
    for (int r = threadIdx.x; r < kKvRows; r += blockDim.x) {
      ls[r] = r < R ? lse[qrow(p0 + r)] : 0.f;
      dls[r] = r < R ? delta[qrow(p0 + r)] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kKvRows * kKvKeys; e += blockDim.x) {
      const int r = e / kKvKeys, t = e - r * kKvKeys;
      float p = 0.f, dsv = 0.f;
      if (r < R && visible((p0 + r) / G, c0 + t, k_end, causal, window)) {
        const float* qa = qs + r * ld;
        const float* da = dos + r * ld;
        const float* kb = ks + t * ld;
        const float* vb = vs + t * ld;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qa[d], kb[d], s);
          dp = fmaf(da[d], vb[d], dp);
        }
        p = expf(s - ls[r]);
        dsv = p * (dp - dls[r]);
      }
      ps[e] = p;
      dss[e] = dsv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kKvKeys * D; e += blockDim.x) {
      const int t = e / D, d = e - t * D;
      float av = dva[e], ak = dka[e];
      for (int r = 0; r < R; ++r) {
        av = fmaf(ps[r * kKvKeys + t], dos[r * ld + d], av);
        ak = fmaf(dss[r * kKvKeys + t], qs[r * ld + d], ak);
      }
      dva[e] = av;
      dka[e] = ak;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    dk[kv_off(t) + d] = dka[e];
    dv[kv_off(t) + d] = dva[e];
  }
}

size_t dq_smem(int D) {
  const size_t ld = D + 1;
  return sizeof(float) * (2 * kDqRows * ld + 2 * kDqKeys * ld +
                          kDqRows * kDqKeys + (size_t)kDqRows * D +
                          2 * kDqRows);
}

size_t dkdv_smem(int D) {
  const size_t ld = D + 1;
  return sizeof(float) * (2 * kKvKeys * ld + 2 * kKvRows * ld +
                          2 * kKvRows * kKvKeys + 2 * (size_t)kKvKeys * D +
                          2 * kKvRows);
}

}  // namespace
}  // namespace repro

// q, o, dout, dq [B, Sq, Hq, D]; k, v, dk, dv [B, Sk, Hkv, D]; lse and
// delta [B, Sq, Hq]: lse from the forward kernel's f32 launch with the
// same mask, delta a scratch this call fills.  All f32 and contiguous.
// The mask arguments are the forward's (repro_flash_attention).  Runs two
// kernels on `stream` (dQ and delta, then dK and dV) and returns the first
// launch error.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
    int window, int kv_len, void* stream) {
  using namespace repro;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      window < 0 || kv_len < 1 || kv_len > Sk ||
      ((causal || window > 0) && Sq != Sk) || dq_smem(D) > kMaxSmem ||
      dkdv_smem(D) > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaError_t err = set_smem(flash_bwd_dq_kernel, dq_smem(D));
  if (err != cudaSuccess) return err;
  err = set_smem(flash_bwd_dkdv_kernel, dkdv_smem(D));
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Sq * G + kDqRows - 1) / kDqRows, Hkv, B);
  flash_bwd_dq_kernel<<<grid_q, kBwdThreads, dq_smem(D), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), Sq, Sk, Hq, Hkv,
      D, causal, window, kv_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Sk + kKvKeys - 1) / kKvKeys, Hkv, B);
  flash_bwd_dkdv_kernel<<<grid_kv, kBwdThreads, dkdv_smem(D), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, Hq, Hkv, D,
      causal, window, kv_len, scale);
  return cudaGetLastError();
}
