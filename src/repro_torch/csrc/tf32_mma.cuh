// 3xTF32 warp-level matrix multiplies (mma.sync m16n8k8, f32 accumulate)
// for f32 products that must keep f32 accuracy on the tensor cores.
//
// An f32 operand a is split into hi = tf32(a) and lo = tf32(a - hi), both
// rounded to nearest (cvt.rna); a.b is then summed as lo.hi + hi.lo +
// hi.hi into f32 accumulators, the small terms first.  The dropped lo.lo
// term and the rounding of lo leave an error near f32's own (about 2^-22
// of |a||b| a term), where one tf32 product alone keeps 2^-11.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)
//                           a3 (g + 8, t + 4)
//   B (8 x 8, k by n):      b0 (t, g)  b1 (t + 4, g)
//   D (16 x 8):             d0 (g, 2t) d1 (g, 2t + 1) d2 (g + 8, 2t)
//                           d3 (g + 8, 2t + 1)
#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d (+)= a.b in one tf32 tensor-core product
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a.b[n] for NT column tiles in 3xTF32 from the split operands:
// each of the three passes runs over every tile, so consecutive products
// write different accumulators and do not wait for each other.
template <int NT>
__device__ __forceinline__ void mma_tf32x3(float (&d)[NT][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], ah, bh[n]);
}

}  // namespace repro
