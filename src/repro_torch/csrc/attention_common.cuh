// Shared device helpers for the paged-attention kernels: dtype
// conversion, the f32 tile dot products and the online-softmax step.
//
// Tiles live in shared memory as f32 rows with a leading dimension of
// D + 1 floats: D is a multiple of 32 for every supported head size, so
// the pad spreads the rows of one column over distinct banks and both the
// score loop (lanes walk key rows) and the P.V loop (lanes walk columns)
// run without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<signed char>(signed char x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Stage `n` rows of D values into smem rows [n][ld] as f32.  Row t comes
// from src + row_off(t); rows with ok(t) false are written as zeros, so a
// masked slot that holds garbage (a foreign request's page, NaN poison)
// can never reach the P.V sum as 0 * NaN.
template <typename T, typename RowOff, typename Ok>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           int n, int D, RowOff row_off,
                                           Ok ok) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    dst[t * ld + d] = ok(t) ? to_f32(src[row_off(t) + d]) : 0.f;
  }
}

// sc[r][t] = <qs[r], ks[t]> for valid (r, t) pairs, -inf elsewhere.
template <typename Valid>
__device__ __forceinline__ void tile_scores(float* sc, const float* qs,
                                            const float* ks, int ld, int R,
                                            int n, int D, Valid valid) {
  for (int e = threadIdx.x; e < R * n; e += blockDim.x) {
    const int r = e / n, t = e - r * n;
    float s = -CUDART_INF_F;
    if (valid(r, t)) {
      const float* a = qs + r * ld;
      const float* b = ks + t * ld;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
      s = acc;
    }
    sc[e] = s;
  }
}

// Online-softmax step for R rows over one staged tile of n scores:
// turns sc into probabilities relative to the new running max, updates
// the running max m and sum l, and leaves each row's rescale factor in
// alpha.  A row with no valid score yet keeps m = -inf, p = 0, alpha = 1,
// so it ends with l = 0 and an all-zero (finite) output.
__device__ __forceinline__ void softmax_step(float* sc, int R, int n,
                                             float* m, float* l,
                                             float* alpha) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* row = sc + r * n;
    float mx = -CUDART_INF_F;
    for (int t = 0; t < n; ++t) mx = fmaxf(mx, row[t]);
    const float m_prev = m[r];
    const float m_new = fmaxf(m_prev, mx);
    float a = 1.f, sum = 0.f;
    if (m_new != -CUDART_INF_F) {
      a = expf(m_prev - m_new);
      for (int t = 0; t < n; ++t) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
    } else {
      for (int t = 0; t < n; ++t) row[t] = 0.f;
    }
    l[r] = l[r] * a + sum;
    m[r] = m_new;
    alpha[r] = a;
  }
}

// acc[r][d] = acc[r][d] * alpha[r] + sum_t p[r][t] * vs[t][d]
__device__ __forceinline__ void tile_pv(float* acc, const float* sc,
                                       const float* vs, const float* alpha,
                                       int ld, int R, int n, int D) {
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const float* p = sc + r * n;
    float a = acc[e] * alpha[r];
    for (int t = 0; t < n; ++t) a = fmaf(p[t], vs[t * ld + d], a);
    acc[e] = a;
  }
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
