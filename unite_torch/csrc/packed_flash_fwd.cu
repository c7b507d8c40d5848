// K3: packed flash attention forward for Hopper (sm_90a), any sequence length.
//
// Replaces the TPU kernel unite_tpu/ops/attention.py::_packed_fwd_kernel
// (called from _packed_flash_fwd). Per head: o = softmax(q.k^T * scale) . v,
// read from and written to the packed layouts [B, S, 3*H*D] -> [B, S, H*D]
// with strides (no head split or merge in device memory), plus the base-2
// row log-sum-exp lse2 = m*c + log2(l), [B, H, S] fp32, when the caller
// trains (K4 reads it).
//
// Contract kept from the TPU kernel: bf16 operands, fp32 accumulation, the
// scale folded into exp2 as c = scale*log2(e), and p = exp2((s - m)*c)
// rounded to bf16 against the EXACT global row max m before the p.v product;
// l = rowsum of the rounded p; o = (p.v) * (1/l). An online-softmax rescale
// would round p against a running max, which is a different function, so the
// kernel sweeps the keys twice: sweep 1 takes the row max of q.k^T, sweep 2
// recomputes q.k^T, forms p, sums l and accumulates p.v. That is 6*S^2*D
// flops a head instead of the 4*S^2*D of the attention itself.
//
// Design. K1 holds a head's whole K and V in shared memory, which stops at
// S = 768 (2*S*72*2 bytes under 227 KB). Here one block of 8 warps takes a
// (batch, head, 128-query tile); each warp keeps its 16 query rows as mma
// A fragments in registers, and K and V stream through shared memory in
// 64-key tiles that every warp of the block reads through ldmatrix. The last
// key tile and the last query tile may be partial (1568 = 24*64 + 32 keys,
// 12*128 + 32 queries): missing key rows are zero-filled and get p = 0,
// missing query rows are computed on zeros and never written.
//
// What bounds it on the H100: at [8, 1568, 2304] the attention is 6.0e10
// flops (0.061 ms at 989 TFLOP/s) against 77 MB of qkv read and o written
// (0.023 ms at 3.35 TB/s), so it is bound by operations, the first kernel of
// the port that is. The tiles of a (batch, head) are neighbours in the grid,
// so a head's K and V come from L2 after the first tile reads them. Each
// stream is double-buffered: cp.async copies tile i+1 into shared memory
// while the warps compute on tile i. The products are mma.sync (wgmma and
// TMA are later work), and exp2 runs on the special-function unit with
// denormal results flushed to 0.
#include "fused_qkv_common.cuh"

using namespace unite;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_Q = WARPS * ROWS_PER_WARP;  // 128 queries a block
constexpr int BLOCK_K = 64;                      // keys a shared-memory tile
constexpr int TILE = BLOCK_K * PITCH;            // elements of one tile buffer

__global__ void __launch_bounds__(THREADS, 2)
    packed_flash_fwd_kernel(const bf16* __restrict__ qkv,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int S, int H, float c) {
  // two buffers a stream: tile i+1 is copied in (cp.async) while the warps
  // compute on tile i
  __shared__ __align__(16) bf16 k_s[2][TILE];
  __shared__ __align__(16) bf16 v_s[2][TILE];

  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = H * HEAD_DIM;
  const size_t stride = 3 * (size_t)hd;
  const bf16* base = qkv + (size_t)b * S * stride;
  const bf16* k_g = base + hd + h * HEAD_DIM;
  const bf16* v_g = base + 2 * hd + h * HEAD_DIM;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BLOCK_Q + (threadIdx.x >> 5) * ROWS_PER_WARP;
  // warps whose 16 rows all lie past S take part in the copies only
  const bool active = r0 < S;
  const int ntiles = (S + BLOCK_K - 1) / BLOCK_K;

  uint32_t qa[4][4];
  load_a_rows(qa, base + h * HEAD_DIM, stride, r0, S);

  // sweep 1: the exact row max over every valid key (K only)
  float m0 = -INFINITY, m1 = -INFINITY;
  load_rows_async(k_s[0], k_g, stride, min(BLOCK_K, S), BLOCK_K);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int k1 = (i + 1) * BLOCK_K;
      load_rows_async(k_s[(i + 1) & 1], k_g + (size_t)k1 * stride, stride,
                      min(BLOCK_K, S - k1), BLOCK_K);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile i have landed
    __syncthreads();     // and every thread's
    const int nk = min(BLOCK_K, S - i * BLOCK_K);
    const bf16* ks = k_s[i & 1];
    if (active) {
      for_steps<BLOCK_K>(nk, [&](int n0, int nk) {
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_rows_t(s[0], qa, ks, n0);
        mma_rows_t(s[1], qa, ks, n0 + 8);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = n0 + half * 8 + 2 * t;
          if (key < nk) { m0 = fmaxf(m0, s[half][0]); m1 = fmaxf(m1, s[half][2]); }
          if (key + 1 < nk) { m0 = fmaxf(m0, s[half][1]); m1 = fmaxf(m1, s[half][3]); }
        }
      });
    }
    __syncthreads();  // tile i's buffer is free for tile i+2
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  // sweep 2: p = exp2((s - m)*c) rounded to bf16, l = rowsum(p), acc = p.v
  float l0 = 0.f, l1 = 0.f;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  load_rows_async(k_s[0], k_g, stride, min(BLOCK_K, S), BLOCK_K);
  load_rows_async(v_s[0], v_g, stride, min(BLOCK_K, S), BLOCK_K);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int k1 = (i + 1) * BLOCK_K;
      load_rows_async(k_s[(i + 1) & 1], k_g + (size_t)k1 * stride, stride,
                      min(BLOCK_K, S - k1), BLOCK_K);
      load_rows_async(v_s[(i + 1) & 1], v_g + (size_t)k1 * stride, stride,
                      min(BLOCK_K, S - k1), BLOCK_K);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int nk = min(BLOCK_K, S - i * BLOCK_K);
    const bf16* ks = k_s[i & 1];
    const bf16* vs = v_s[i & 1];
    if (active) {
      for_steps<BLOCK_K>(nk, [&](int n0, int nk) {
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_rows_t(s[0], qa, ks, n0);
        mma_rows_t(s[1], qa, ks, n0 + 8);
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = n0 + half * 8 + 2 * t;
          const bool ok0 = key < nk, ok1 = key + 1 < nk;
          const bf16 p00 = __float2bfloat16_rn(ok0 ? fast_exp2((s[half][0] - m0) * c) : 0.f);
          const bf16 p01 = __float2bfloat16_rn(ok1 ? fast_exp2((s[half][1] - m0) * c) : 0.f);
          const bf16 p10 = __float2bfloat16_rn(ok0 ? fast_exp2((s[half][2] - m1) * c) : 0.f);
          const bf16 p11 = __float2bfloat16_rn(ok1 ? fast_exp2((s[half][3] - m1) * c) : 0.f);
          l0 += __bfloat162float(p00) + __bfloat162float(p01);
          l1 += __bfloat162float(p10) + __bfloat162float(p11);
          pa[2 * half] = pack_raw(p00, p01);      // row g
          pa[2 * half + 1] = pack_raw(p10, p11);  // row g + 8
        }
        mma_p_x(acc, pa, vs, n0);
      });
    }
    __syncthreads();
  }
  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  store_rows(out + (size_t)b * S * hd + h * HEAD_DIM, hd, acc, r0, S,
             1.f / l0, 1.f / l1);
  if (lse != nullptr && t == 0) {
    float* lse_row = lse + ((size_t)b * H + h) * S;
    if (r0 + g < S) lse_row[r0 + g] = m0 * c + log2f(l0);
    if (r0 + g + 8 < S) lse_row[r0 + g + 8] = m1 * c + log2f(l1);
  }
}

// qkv [B, S, 3*H*64] bf16 -> out [B, S, H*64] bf16, lse [B, H, S] fp32 (or
// null). c = scale*log2(e). Launches on `stream`; returns cudaGetLastError().
extern "C" int unite_packed_flash_fwd(const void* qkv, void* out, void* lse,
                                      int B, int S, int H, float c,
                                      void* stream) {
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  packed_flash_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, H, c);
  return (int)cudaGetLastError();
}
