// The products of the wgmma attention backwards (csrc/flash_bwd_wgmma.cu
// and csrc/short_bwd_wgmma.cu): 64 resident rows a consumer warpgroup,
// read once from their TMA-written tile into registers as wgmma A
// fragments, against 64-row tiles in shared memory (128-byte swizzle):
// the score products x.y^T with the tile K-major, and the gradient
// products p.x with the tile MN-major (transpose bit). Each product is
// m64n64k16 over four k-steps, and one or two products make a commit
// group.
#pragma once

#include "fused_qkv_common.cuh"
#include "hopper.cuh"

namespace attn_bwd {

using namespace hopper;
using unite::bf16;

// Descriptors of a 64-row tile: K-major (its 64 lanes are the product's
// depth) and MN-major (its rows are).
__device__ __forceinline__ uint64_t kmajor(const bf16* tile) {
  return desc_b128(tile, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(const bf16* tile) {
  return desc_b128(tile, 0, 1024);
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

// Start a = x.y^T for this warpgroup's 64 resident rows (x: A fragments in
// registers) and a 64-row streamed tile (y: K-major in shared memory):
// four k-steps of 16 lanes, each 32 bytes further into the swizzle atom.
// One commit group.
__device__ __forceinline__ void score_start(float (&a)[32],
                                            const uint32_t (&xa)[4][4],
                                            uint64_t yd) {
  reg_fence(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs(a, xa[kk], yd + 2 * kk, kk);
  wgmma_commit();
}

// The two score products of a streamed tile, s first: two commit groups.
__device__ __forceinline__ void scores_start(float (&a)[32], float (&b)[32],
                                             const uint32_t (&xa)[4][4],
                                             uint64_t yd,
                                             const uint32_t (&ua)[4][4],
                                             uint64_t wd) {
  score_start(a, xa, yd);
  score_start(b, ua, wd);
}

// acc += p . x for a 64-row streamed tile x read MN-major: four k-steps of
// 16 rows, each 16 rows (2048 bytes) further into the tile.
__device__ __forceinline__ void grad_mma(float (&acc)[32],
                                         uint32_t (&p)[4][4], uint64_t xd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs_tb(acc, p[kk], xd + 128 * kk, 1);
}

__device__ __forceinline__ void grad_fence(float (&acc)[32],
                                           uint32_t (&p)[4][4]) {
  reg_fence(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) reg_fence(p[kk]);
}

// Start dq's gradient product, one commit group.
__device__ __forceinline__ void grad_start(float (&acc)[32],
                                           uint32_t (&p)[4][4], uint64_t xd) {
  grad_fence(acc, p);
  wgmma_fence();
  grad_mma(acc, p, xd);
  wgmma_commit();
}

// Start dkv's two gradient products, one commit group.
__device__ __forceinline__ void grads_start(float (&a0)[32],
                                            uint32_t (&p0)[4][4], uint64_t x0,
                                            float (&a1)[32],
                                            uint32_t (&p1)[4][4],
                                            uint64_t x1) {
  grad_fence(a0, p0);
  grad_fence(a1, p1);
  wgmma_fence();
  grad_mma(a0, p0, x0);
  grad_mma(a1, p1, x1);
  wgmma_commit();
}

}  // namespace attn_bwd
