// Warp-level tensor-core tile products (mma.sync) for the flash kernels
// that run on them: the f32 forward (flash_attention.cu) and the backward
// in both dtypes (flash_attention_bwd.cu).  f32 runs 3xTF32 (tf32_mma.cuh:
// m16n8k8, hi/lo split with rna rounding, lo.lo dropped), which keeps f32
// accuracy; bf16 runs m16n8k16.  Both accumulate in f32.
//
// A warp owns 16 rows of a product's output in mma's accumulator layout:
// tile n of acc[NT][4] holds rows g and g + 8 (g = lane / 4) at columns
// 8n + 2t and 8n + 2t + 1 (t = lane % 4), as {c0, c1} and {c2, c3}.
//
// One convention for the contraction axis k in both types: a thread holds
// the pairs k = 2t, 2t + 1 (and 2t + 8, 2t + 9 in bf16's k16 step) of
// every operand.  That is bf16's own fragment layout and the accumulator's
// column layout, so an accumulator (P, dS) is the A operand of the next
// product as it stands: S -> P -> dS never leave the registers.  tf32's
// m16n8k8 holds k = t and t + 4 instead; a contraction may run in any
// order, so the f32 step feeds its physical slot t with logical k 2t and
// slot t + 4 with 2t + 1, in A and B alike.
//
// Operands in shared memory are row-major tiles with a row stride `ld`:
// `load_a` and `load_bt` read along a row (k contiguous), `load_b` down a
// column (k is the row); f32 by 8- and 4-byte loads, split in registers or
// ahead of time (split_tile), bf16 by ldmatrix (.trans for `load_b`).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "hopper_mma.cuh"
#include "tf32_mma.cuh"

namespace repro {

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// hi = tf32(v), lo = tf32(v - hi), both rounded to nearest with ties away
// from zero (rna), as tf32_split: adding half of the 13 dropped bits to the
// magnitude and clearing them is that rounding for every finite value, in
// two integer instructions a rounding (cvt.rna.tf32.f32 adds a test and a
// select for non-finite values, which staged tiles never hold: masked
// slots are zeros).
__device__ __forceinline__ void tf32_split_rna(float v, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// ldmatrix: 8x8 tiles of 16-bit values from shared memory into mma
// fragments; lanes 0-7 give the rows of the first tile, 8-15 the second's,
// and so on.  A thread receives (row lane / 4, columns 2 (lane % 4) and
// + 1) of each tile, or with .trans (rows 2 (lane % 4) and + 1, column
// lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// 4 bytes from global to shared memory, asynchronously; !valid fills
// zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// floor(a / G) for 0 <= a < 2^15 from inv_g = 1 / G: (a + 0.5) / G lies at
// least 0.5 / G from an integer, far beyond the product's rounding.
__device__ __forceinline__ int div_small(int a, float inv_g) {
  return __float2int_rd((static_cast<float>(a) + 0.5f) * inv_g);
}

// d (+)= a.b, bf16 m16n8k16 with f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Frag;

template <>
struct Frag<float> {
  static constexpr int KS = 8;  // k a step
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  // x: row g's pair (k 2t, 2t + 1), y: row g + 8's, into the slots a0 (g,
  // t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
  static __device__ __forceinline__ A make_a(float2 x, float2 y) {
    A f;
    tf32_split_rna(x.x, f.hi[0], f.lo[0]);
    tf32_split_rna(y.x, f.hi[1], f.lo[1]);
    tf32_split_rna(x.y, f.hi[2], f.lo[2]);
    tf32_split_rna(y.y, f.hi[3], f.lo[3]);
    return f;
  }
  // k 2t, 2t + 1 into the slots b0 (t, g), b1 (t + 4, g)
  static __device__ __forceinline__ B make_b(float k0, float k1) {
    B f;
    tf32_split_rna(k0, f.hi[0], f.lo[0]);
    tf32_split_rna(k1, f.hi[1], f.lo[1]);
    return f;
  }
  // A = s[r0 + row][k0 + k]
  static __device__ __forceinline__ A load_a(const float* s, int ld, int r0,
                                             int k0) {
    const float* p = s + (r0 + lane_g()) * ld + k0 + 2 * lane_t();
    return make_a(*reinterpret_cast<const float2*>(p),
                  *reinterpret_cast<const float2*>(p + 8 * ld));
  }
  // A = accumulator tiles (k step kk is tile kk)
  template <int N>
  static __device__ __forceinline__ A acc_a(const float (&c)[N][4], int kk) {
    return make_a(make_float2(c[kk][0], c[kk][1]),
                  make_float2(c[kk][2], c[kk][3]));
  }
  // B(k, n) = s[n0 + n][k0 + k]
  static __device__ __forceinline__ B load_bt(const float* s, int ld, int n0,
                                              int k0) {
    const float2 x = *reinterpret_cast<const float2*>(
        s + (n0 + lane_g()) * ld + k0 + 2 * lane_t());
    return make_b(x.x, x.y);
  }
  // B(k, n) = s[k0 + k][n0 + n]
  static __device__ __forceinline__ B load_b(const float* s, int ld, int k0,
                                             int n0) {
    const float* p = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
    return make_b(p[0], p[ld]);
  }
  // The same B fragments from a tile split ahead of time (split_tile):
  // hi[...] and lo[...] hold the tf32 bit patterns of each staged value.
  static __device__ __forceinline__ B load_bt(const float* hi,
                                              const float* lo, int ld,
                                              int n0, int k0) {
    const int o = (n0 + lane_g()) * ld + k0 + 2 * lane_t();
    const float2 h = *reinterpret_cast<const float2*>(hi + o);
    const float2 l = *reinterpret_cast<const float2*>(lo + o);
    return B{{__float_as_uint(h.x), __float_as_uint(h.y)},
             {__float_as_uint(l.x), __float_as_uint(l.y)}};
  }
  static __device__ __forceinline__ B load_b(const float* hi, const float* lo,
                                             int ld, int k0, int n0) {
    const int o = (k0 + 2 * lane_t()) * ld + n0 + lane_g();
    return B{{__float_as_uint(hi[o]), __float_as_uint(hi[o + ld])},
             {__float_as_uint(lo[o]), __float_as_uint(lo[o + ld])}};
  }
  // d[n0 + j] += a.b[j] in 3xTF32, each pass over every tile so that
  // consecutive products write different accumulators
  template <int NT, int NB>
  static __device__ __forceinline__ void mma(float (&d)[NT][4], int n0,
                                             const A& a, const B (&b)[NB]) {
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32(d[n0 + j], a.lo, b[j].hi);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32(d[n0 + j], a.hi, b[j].lo);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32(d[n0 + j], a.hi, b[j].hi);
  }
};

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int KS = 16;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };
  static __device__ __forceinline__ uint32_t round2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // registers (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..):
  // the tiles (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  static __device__ __forceinline__ A load_a(const __nv_bfloat16* s, int ld,
                                             int r0, int k0) {
    const int l = threadIdx.x & 31;
    A f;
    ldsm_x4(f.x, s + (r0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
    return f;
  }
  // k step kk covers accumulator tiles 2kk and 2kk + 1, rounded to bf16
  template <int N>
  static __device__ __forceinline__ A acc_a(const float (&c)[N][4], int kk) {
    return A{{round2(c[2 * kk][0], c[2 * kk][1]),
              round2(c[2 * kk][2], c[2 * kk][3]),
              round2(c[2 * kk + 1][0], c[2 * kk + 1][1]),
              round2(c[2 * kk + 1][2], c[2 * kk + 1][3])}};
  }
  // the tiles (n 0-7, k 0-7) and (n 0-7, k 8-15) of s[n][k]
  static __device__ __forceinline__ B load_bt(const __nv_bfloat16* s, int ld,
                                              int n0, int k0) {
    const int l = threadIdx.x & 15;
    B f;
    ldsm_x2(f.x, s + (n0 + (l & 7)) * ld + k0 + (l >> 3) * 8);
    return f;
  }
  // the tiles (k 0-7, n 0-7) and (k 8-15, n 0-7) of s[k][n], transposed
  static __device__ __forceinline__ B load_b(const __nv_bfloat16* s, int ld,
                                             int k0, int n0) {
    const int l = threadIdx.x & 15;
    B f;
    ldsm_x2_trans(f.x, s + (k0 + l) * ld + n0);
    return f;
  }
  template <int NT, int NB>
  static __device__ __forceinline__ void mma(float (&d)[NT][4], int n0,
                                             const A& a, const B (&b)[NB]) {
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_bf16(d[n0 + j], a.x, b[j].x);
  }
};

// acc[n] += sum over KSTEPS k steps of A(ks) . B(ks, n) for n < NT, with
// aload(ks) -> F::A and bload(ks, n) -> F::B for F = Frag<T>; B is loaded
// four column tiles at a time.
template <typename F, int NT, int KSTEPS, typename ALoad, typename BLoad>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4],
                                             ALoad aload, BLoad bload) {
  constexpr int NB = NT < 4 ? NT : 4;
  static_assert(NT % NB == 0, "column tiles in groups of four");
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const typename F::A a = aload(ks);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NB) {
      typename F::B b[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) b[j] = bload(ks, n0 + j);
      F::template mma<NT, NB>(acc, n0, a, b);
    }
  }
}

// The 3xTF32 product of warp_product with f32's rounding in its long
// sums: the tensor cores add into an accumulator without rounding to
// nearest, an error of up to 2^-23 of the running sum an addition, which
// a long chain (a 64-wide dot product, a P.V over many keys) compounds
// one way and an exponent (the softmax) amplifies.  So each k step's
// hi.hi product starts from zero and is added to `big` by an f32 add,
// while the lo.hi and hi.lo products, ~2^-11 of it, accumulate on the
// tensor cores in `small`; the sum is big + small.
template <int NT, int KSTEPS, typename ALoad, typename BLoad>
__device__ __forceinline__ void warp_product_rn(float (&big)[NT][4],
                                                float (&small)[NT][4],
                                                ALoad aload, BLoad bload) {
  using F = Frag<float>;
  constexpr int NB = NT < 4 ? NT : 4;
  static_assert(NT % NB == 0, "column tiles in groups of four");
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const F::A a = aload(ks);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NB) {
      F::B b[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) b[j] = bload(ks, n0 + j);
      float t[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
        mma_tf32(t[j], a.hi, b[j].hi);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_tf32(small[n0 + j], a.lo, b[j].hi);
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_tf32(small[n0 + j], a.hi, b[j].lo);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[n0 + j][e] += t[j][e];
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Rows [0, n) of a [n][ld] tile of D values each by 16-byte cp.async,
// left in flight (the caller commits and waits): row i from row(i), a
// 16-byte aligned pointer, or zeros where row(i) is null (`any` is any
// valid address, never read).
template <typename T, int D, int NTHREADS, typename Row>
__device__ __forceinline__ void stage_tile(T* dst, int ld, int n,
                                           const T* any, Row row) {
  constexpr int E = 16 / sizeof(T), C = D / E;
  for (int e = threadIdx.x; e < n * C; e += NTHREADS) {
    const int i = e / C, c = e - i * C;
    const T* src = row(i);
    cp_async16(dst + i * ld + c * E, src != nullptr ? src + c * E : any,
               src != nullptr);
  }
}

// Split rows [0, n) of a staged f32 [n][ld] tile of D values a row ahead
// of its products, once for every warp that reads it: each value becomes
// its tf32 hi in place and its lo in the same place of `lo`.
template <int D, int NTHREADS>
__device__ __forceinline__ void split_tile(float* x, float* lo, int ld,
                                           int n) {
  constexpr int C = D / 4;
  for (int e = threadIdx.x; e < n * C; e += NTHREADS) {
    const int i = e / C, o = i * ld + (e - i * C) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + o);
    uint4 h, l;
    tf32_split_rna(v.x, h.x, l.x);
    tf32_split_rna(v.y, h.y, l.y);
    tf32_split_rna(v.z, h.z, l.z);
    tf32_split_rna(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(x + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace repro
