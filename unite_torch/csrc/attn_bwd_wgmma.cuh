// The products of the wgmma attention backwards (csrc/flash_bwd_wgmma.cu
// and csrc/short_bwd_wgmma.cu): 64 resident rows a consumer warpgroup,
// read once from their TMA-written tile into registers as wgmma A
// fragments, against 64-row tiles in shared memory (128-byte swizzle):
// the score products x.y^T with the tile K-major, and the gradient
// products p.x with the tile MN-major (transpose bit). Each product is
// m64n64k16 over four k-steps, and one or two products make a commit
// group. At head dim 80 (template argument D) lanes 64-79 of every row sit
// in a second tile of 32-byte rows (32-byte swizzle): a score product takes
// a fifth k-step on them (A from registers or, for rows that stay in shared
// memory, from their tile), and a gradient product a second product,
// m64n16k16, into 8 more accumulators a thread.
#pragma once

#include "fused_qkv_common.cuh"
#include "hopper.cuh"

namespace attn_bwd {

using namespace hopper;
using unite::bf16;
using unite::tail_regs;

// Descriptors of a 64-row tile: K-major (its 64 lanes are the product's
// depth) and MN-major (its rows are).
__device__ __forceinline__ uint64_t kmajor(const bf16* tile) {
  return desc_b128(tile, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(const bf16* tile) {
  return desc_b128(tile, 0, 1024);
}

// The same of a 64-row tile of lanes 64-79 (32-byte rows).
__device__ __forceinline__ uint64_t kmajor_t(const bf16* tile) {
  return desc_b32(tile, 16, 256);
}

__device__ __forceinline__ uint64_t mnmajor_t(const bf16* tile) {
  return desc_b32(tile, 0, 256);
}

// The A fragments of this warp's 16 rows (16w + g, + 8) of a 64-row
// K-major tile as TMA wrote it (128-byte swizzle: the 16-byte chunk c of
// row r sits at chunk c ^ (r & 7)): k-step kk covers lanes 16kk..16kk+15,
// chunks 2kk and 2kk + 1. A quad's lanes read one chunk, the 8 rows of a
// warp 8 distinct chunks: no bank conflicts.
__device__ __forceinline__ void load_frags(uint32_t (&a)[4][4],
                                           const bf16* tile, int w, int g,
                                           int t) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(tile);
  const int r0 = 16 * w + g, r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int chunk = 2 * kk + half;
      a[kk][2 * half] = *reinterpret_cast<const uint32_t*>(
          base + r0 * 128 + ((chunk ^ (r0 & 7)) << 4) + 4 * t);
      a[kk][2 * half + 1] = *reinterpret_cast<const uint32_t*>(
          base + r1 * 128 + ((chunk ^ (r1 & 7)) << 4) + 4 * t);
    }
}

// The A fragment of lanes 64-79 (the fifth k-step) of this warp's 16 rows
// of a 64-row tile of 32-byte rows as TMA wrote it (32-byte swizzle: the
// 16-byte chunk c of row r sits at chunk c ^ ((r >> 2) & 1)).
__device__ __forceinline__ void load_tail_frag(uint32_t (&a)[4],
                                               const bf16* tile, int w, int g,
                                               int t) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(tile);
  const int r0 = 16 * w + g, r1 = r0 + 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    a[2 * half] = *reinterpret_cast<const uint32_t*>(
        base + r0 * 32 + ((half ^ ((r0 >> 2) & 1)) << 4) + 4 * t);
    a[2 * half + 1] = *reinterpret_cast<const uint32_t*>(
        base + r1 * 32 + ((half ^ ((r1 >> 2) & 1)) << 4) + 4 * t);
  }
}

// The two bf16 values of a pair, rounded by one packed conversion.
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// An accumulator of N floats a thread (m64n64: 32; the narrow last chunk's
// m64n16: 8) rounded to bf16 a pair at a time, as the A fragments of a
// product whose depth is its columns: k-step kk covers columns
// 16kk..16kk+15, n8 blocks 2kk and 2kk + 1, so no shuffles.
template <int N>
__device__ __forceinline__ void pack_pairs(const float (&s)[N],
                                           uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * kk + half;
      a[kk][2 * half] = bf2(s[4 * i], s[4 * i + 1]);          // row g
      a[kk][2 * half + 1] = bf2(s[4 * i + 2], s[4 * i + 3]);  // row g + 8
    }
}

// A score product's fifth k-step at head dim 80: x's lanes 64-79 as A
// fragments in registers, or as a K-major tile in shared memory (its
// descriptor), against y's lanes 64-79 K-major.
__device__ __forceinline__ void score_tail(float (&a)[32],
                                           const uint32_t (&xt)[4],
                                           uint64_t ytd) {
  wgmma_m64n64k16_rs(a, xt, ytd, 1);
}

__device__ __forceinline__ void score_tail(float (&a)[32], uint64_t xtd,
                                           uint64_t ytd) {
  wgmma_m64n64k16_ss(a, xtd, ytd, 1);
}

// Start a = x.y^T for this warpgroup's 64 resident rows (x: A fragments in
// registers) and a 64-row streamed tile (y: K-major in shared memory):
// four k-steps of 16 lanes, each 32 bytes further into the swizzle atom,
// and at D = 80 the fifth (x's lanes 64-79 xt, y's ytd). One commit group.
template <int D, typename XT>
__device__ __forceinline__ void score_start(float (&a)[32],
                                            const uint32_t (&xa)[4][4],
                                            uint64_t yd, const XT& xt,
                                            uint64_t ytd) {
  reg_fence(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs(a, xa[kk], yd + 2 * kk, kk);
  if constexpr (D == 80) score_tail(a, xt, ytd);
  wgmma_commit();
}

// The two score products of a streamed tile, s first: two commit groups.
template <int D, typename XT>
__device__ __forceinline__ void scores_start(
    float (&a)[32], float (&b)[32], const uint32_t (&xa)[4][4], uint64_t yd,
    const XT& xt, uint64_t ytd, const uint32_t (&ua)[4][4], uint64_t wd,
    const XT& ut, uint64_t wtd) {
  score_start<D>(a, xa, yd, xt, ytd);
  score_start<D>(b, ua, wd, ut, wtd);
}

// acc += p . x for a 64-row streamed tile x read MN-major: four k-steps of
// 16 rows, each 16 rows (2048 bytes) further into the tile; at D = 80 also
// acc_t += p . x's lanes 64-79 (xtd, 16 rows of 32 bytes a k-step).
template <int D, int NT>
__device__ __forceinline__ void grad_mma(float (&acc)[32], float (&acc_t)[NT],
                                         uint32_t (&p)[4][4], uint64_t xd,
                                         uint64_t xtd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs_tb(acc, p[kk], xd + 128 * kk, 1);
  if constexpr (D == 80) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n16k16_rs_tb(acc_t, p[kk], xtd + 32 * kk, 1);
  }
}

template <int D, int NT>
__device__ __forceinline__ void grad_fence(float (&acc)[32],
                                           float (&acc_t)[NT],
                                           uint32_t (&p)[4][4]) {
  reg_fence(acc);
  if constexpr (D == 80) reg_fence(acc_t);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) reg_fence(p[kk]);
}

// Start dq's gradient product, one commit group.
template <int D, int NT>
__device__ __forceinline__ void grad_start(float (&acc)[32],
                                           float (&acc_t)[NT],
                                           uint32_t (&p)[4][4], uint64_t xd,
                                           uint64_t xtd) {
  grad_fence<D>(acc, acc_t, p);
  wgmma_fence();
  grad_mma<D>(acc, acc_t, p, xd, xtd);
  wgmma_commit();
}

// Start dkv's two gradient products, one commit group.
template <int D, int NT>
__device__ __forceinline__ void grads_start(
    float (&a0)[32], float (&a0t)[NT], uint32_t (&p0)[4][4], uint64_t x0,
    uint64_t x0t, float (&a1)[32], float (&a1t)[NT], uint32_t (&p1)[4][4],
    uint64_t x1, uint64_t x1t) {
  grad_fence<D>(a0, a0t, p0);
  grad_fence<D>(a1, a1t, p1);
  wgmma_fence();
  grad_mma<D>(a0, a0t, p0, x0, x0t);
  grad_mma<D>(a1, a1t, p1, x1, x1t);
  wgmma_commit();
}

// After a wait that retired a gradient product: keep its accumulators'
// reads and writes after it.
template <int D, int NT>
__device__ __forceinline__ void acc_fence(float (&acc)[32],
                                          float (&acc_t)[NT]) {
  reg_fence(acc);
  if constexpr (D == 80) reg_fence(acc_t);
}

// Store a 64 x D fp32 accumulator (acc lanes 0-63, acc_t lanes 64-79)
// times m0 (row `row`) and m1 (row `row + 8`, this thread's) as bf16 rows
// of a view's head; rows at or past S are dropped.
template <int D, int NT>
__device__ __forceinline__ void store_rows(bf16* base, long long sr,
                                           const float (&acc)[32],
                                           const float (&acc_t)[NT], int row,
                                           int S, int t, float m0, float m1) {
#pragma unroll
  for (int i = 0; i < (D == 80 ? 10 : 8); ++i) {
    const int col = 8 * i + 2 * t;
    const float* a = i < 8 ? acc + 4 * i : acc_t + 4 * (i - 8);
    if (row < S)
      *reinterpret_cast<uint32_t*>(base + row * sr + col) =
          bf2(a[0] * m0, a[1] * m0);
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (row + 8) * sr + col) =
          bf2(a[2] * m1, a[3] * m1);
  }
}

}  // namespace attn_bwd
