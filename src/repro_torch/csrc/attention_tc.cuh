// The consumer half of the bf16 tensor-core attention kernels (sm_90a):
// `flash_tc_kernel` (flash_attention.cu) and `prefix_prefill_tc_kernel`
// (paged_prefix_prefill_attention.cu).  Both keep one 64-row tile of
// packed query rows in shared memory and walk 64-key K/V tiles; they
// differ only in where the tiles come from (TMA over a dense [B, S, Hkv,
// D] tensor, or cp.async gathers through a block table) and in their
// masks.
//
// Tiles are 64 rows of D bf16 values in the layout a TMA load with a
// 128-byte swizzle (64-byte at D = 32) gives: REGIONS regions of RB bytes
// of each row, a region's 64 rows at RB bytes each, 16-byte chunks of a
// row permuted by the row's index mod 8.  Every tile starts on a
// 1024-byte boundary.  One consumer warpgroup (128 threads) owns a tile:
// thread t holds rows tc_row(0) and tc_row(1) of it.
#pragma once

#include <cstdint>

#include "attention_common.cuh"
#include "hopper_mma.cuh"

namespace repro {

constexpr int kTcRows = 64;   // packed query rows a block
constexpr int kTcKeys = 64;   // keys a K/V tile

template <int D>
struct TcTile {
  static constexpr int RB = D * 2 < 128 ? D * 2 : 128;  // bytes a row
  static constexpr int REGIONS = D * 2 / RB;             // of RB bytes
  static constexpr int SWIZZLE = RB == 128 ? 1 : 2;      // 128 B / 64 B
  static constexpr int BYTES = 64 * D * 2;               // one 64-row tile
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of the 16-byte chunk `cc` (values 8cc .. 8cc + 7) of row
// `row` in a swizzled 64-row tile.
template <int D>
__device__ __forceinline__ uint32_t tc_chunk(int row, int cc) {
  using Sh = TcTile<D>;
  const int kr = cc * 16 / Sh::RB, c16 = cc % (Sh::RB / 16);
  const uint32_t o = kr * 64 * Sh::RB + row * Sh::RB + c16 * 16;
  return o ^ ((o >> 3) & (Sh::SWIZZLE == 1 ? 0x70 : 0x30));
}

// The tile row this consumer thread holds as its half hr (0 or 1).
__device__ __forceinline__ int tc_row(int hr) {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4 + 8 * hr;
}

// One K/V tile of the online softmax: S = Q.K^T by wgmma m64n64k16 (Q and
// K K-major from shared memory, f32 accumulators in registers); where
// `edge`, the scores for which hidden(col, hr) holds are set to -inf (a
// select, never a multiply: a hidden key's V row must be finite, and is
// zero where the caller cannot vouch for it); the running max m, this
// thread's share l of the row sums and the output o are updated in the
// log2 domain (scores times scale_log2); then O += P.V, P converted to
// bf16 in registers as the A operand and V the MN-major B operand.  A row
// that has seen no visible key keeps m = -inf, l = 0 and o = 0.
template <int D, typename Hidden>
__device__ __forceinline__ void tc_attend_tile(
    const unsigned char* qs, const unsigned char* kt,
    const unsigned char* vt, bool edge, Hidden hidden, float scale_log2,
    float (&o)[D / 2], float (&m)[2], float (&l)[2]) {
  using Sh = TcTile<D>;
  constexpr int RB = Sh::RB, BN = kTcKeys;
  constexpr uint32_t SBO = 8 * RB;
  const int c2 = (threadIdx.x % 4) * 2;

  float sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  fence_operands(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int kr = kk * 32 / RB, kb = (kk * 32) % RB;
    wgmma_ss_n64(sc,
                 gmma_desc(qs + kr * kTcRows * RB + kb, 16, SBO,
                           Sh::SWIZZLE),
                 gmma_desc(kt + kr * BN * RB + kb, 16, SBO, Sh::SWIZZLE),
                 kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(sc);

  if (edge) {
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (hidden(nb * 8 + c2 + (e & 1), e >> 1))
          sc[nb * 4 + e] = -CUDART_INF_F;
  }

  // online softmax in registers, rows tc_row(0) (hr 0) and tc_row(1)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
      mx = fmaxf(mx, fmaxf(sc[nb * 4 + 2 * hr], sc[nb * 4 + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[hr], mx);
    const float mu = mn == -CUDART_INF_F ? 0.f : mn * scale_log2;
    const float alpha = exp2f(m[hr] * scale_log2 - mu);  // 0 at -inf
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[nb * 4 + 2 * hr + e];
        x = exp2f(fmaf(x, scale_log2, -mu));
        sum += x;
      }
    l[hr] = fmaf(l[hr], alpha, sum);  // this thread's share of the row
    m[hr] = mn;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[nb * 4 + 2 * hr] *= alpha;
      o[nb * 4 + 2 * hr + 1] *= alpha;
    }
  }

  // P to bf16 in the A-operand layout, then O += P.V
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const float* lo = sc + 8 * kk;  // n8 blocks 2kk and 2kk + 1
    pa[kk][0] = pack_bf16(lo[0], lo[1]);
    pa[kk][1] = pack_bf16(lo[2], lo[3]);
    pa[kk][2] = pack_bf16(lo[4], lo[5]);
    pa[kk][3] = pack_bf16(lo[6], lo[7]);
  }
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv = gmma_desc(vt + kk * 16 * RB, BN * RB, SBO,
                                  Sh::SWIZZLE);
    if constexpr (D == 32) wgmma_rs_n32(o, pa[kk], dv);
    else if constexpr (D == 64) wgmma_rs_n64(o, pa[kk], dv);
    else wgmma_rs_n128(o, pa[kk], dv);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(o);
}

// O / l for this thread's rows that are below R, written as bf16 to
// orow(row) (the row's D values in device memory).
template <int D, typename OutRow>
__device__ __forceinline__ void tc_store(const float (&o)[D / 2],
                                         const float (&l)[2], int R,
                                         OutRow orow) {
  const int c2 = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int lr = tc_row(hr);
    if (lr < R) {
      __nv_bfloat16* dst = orow(lr);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<uint32_t*>(dst + nb * 8 + c2) = pack_bf16(
            o[nb * 4 + 2 * hr] * inv, o[nb * 4 + 2 * hr + 1] * inv);
    }
  }
}

}  // namespace repro
