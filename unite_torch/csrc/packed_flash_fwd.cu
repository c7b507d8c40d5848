// Flash attention forward for Hopper (sm_90a) over strided [B, H, S, 64]
// views, S <= 512: K5, which replaces
// unite_tpu/ops/attention.py::_grouped_fwd_kernel (called from
// _grouped_attention_fwd), the models' route for training at 385-512
// tokens (392 = stage 1 at mask 0.75) and for widths that are not a
// multiple of 128.
//
// Per head: o = softmax(q.k^T * scale) . v, and the raw row max m and the
// row sum l, [B, H, S] fp32 each, when the caller trains (its backward
// recomputes e = exp2((s - m)*c) against the exact m).
//
// Contract kept from the TPU kernel: bf16 operands, fp32 accumulation, the
// scale folded into exp2 as c = scale*log2(e), and p = exp2((s - m)*c)
// rounded to bf16 against the EXACT global row max m before the p.v
// product; o = (p.v) * (1/l), with l the row sum of the fp32 e BEFORE the
// rounding (_grouped_fwd_kernel :459). An online-softmax rescale would
// round p against a running max, which is a different function, so the
// kernel sweeps the keys twice: sweep 1 takes the row max of q.k^T, sweep 2
// recomputes q.k^T, forms p, sums l and accumulates p.v.
//
// Design. One block of 8 warps takes a (batch, head, 128-query tile);
// each warp keeps its 16 query rows as mma A fragments in registers, and K
// and V stream through shared memory in 64-key tiles that every warp of
// the block reads through ldmatrix, double-buffered with cp.async. The
// last key tile and the last query tile may be partial (392 = 6*64 + 8
// keys): missing key rows are zero-filled and get p = 0, missing query
// rows are computed on zeros and never written.
//
// What bounds it on the H100: at the stage-1 mask-0.75 shape
// [64, 12, 392, 64] it moves 38.5 MB a tensor (q, k, v, o: 0.046 ms at
// 3.35 TB/s) against 3.0e10 flops of attention (0.031 ms at 989 TFLOP/s),
// so it is bound by bytes; the 4 query tiles of a head read K and V from
// L2 after the first. The TPU's G heads a program amortised its program
// launch; here a block per (batch, head, 128 queries) already gives 3072
// blocks, about 12 waves at two blocks an SM, so nothing is grouped.
#include "fused_qkv_common.cuh"

using namespace unite;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_Q = WARPS * ROWS_PER_WARP;  // 128 queries a block
constexpr int BLOCK_K = 64;                      // keys a shared-memory tile
constexpr int TILE = BLOCK_K * PITCH;            // elements of one tile buffer

// m and l: both null or both set.
__global__ void __launch_bounds__(THREADS, 2)
    grouped_fwd_kernel(View q, View k, View v, View o, float* __restrict__ m,
                       float* __restrict__ l, int S, int H, float c) {
  // two buffers a stream: tile i+1 is copied in (cp.async) while the warps
  // compute on tile i
  __shared__ __align__(16) bf16 k_s[2][TILE];
  __shared__ __align__(16) bf16 v_s[2][TILE];

  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* k_g = k.head(b, h);
  const bf16* v_g = v.head(b, h);
  const size_t ks_r = k.sr, vs_r = v.sr;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BLOCK_Q + (threadIdx.x >> 5) * ROWS_PER_WARP;
  // warps whose 16 rows all lie past S take part in the copies only
  const bool active = r0 < S;
  const int ntiles = (S + BLOCK_K - 1) / BLOCK_K;

  uint32_t qa[4][4];
  load_a_rows(qa, q.head(b, h), q.sr, r0, S);

  // sweep 1: the exact row max over every valid key (K only)
  float m0 = -INFINITY, m1 = -INFINITY;
  load_rows_async(k_s[0], k_g, ks_r, min(BLOCK_K, S), BLOCK_K);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int k1 = (i + 1) * BLOCK_K;
      load_rows_async(k_s[(i + 1) & 1], k_g + (size_t)k1 * ks_r, ks_r,
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

  // sweep 2: p = exp2((s - m)*c) rounded to bf16, l = the row sum of the
  // fp32 e before rounding, acc = p.v
  float l0 = 0.f, l1 = 0.f;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  load_rows_async(k_s[0], k_g, ks_r, min(BLOCK_K, S), BLOCK_K);
  load_rows_async(v_s[0], v_g, vs_r, min(BLOCK_K, S), BLOCK_K);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int k1 = (i + 1) * BLOCK_K;
      load_rows_async(k_s[(i + 1) & 1], k_g + (size_t)k1 * ks_r, ks_r,
                      min(BLOCK_K, S - k1), BLOCK_K);
      load_rows_async(v_s[(i + 1) & 1], v_g + (size_t)k1 * vs_r, vs_r,
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
          const float e00 = ok0 ? fast_exp2((s[half][0] - m0) * c) : 0.f;
          const float e01 = ok1 ? fast_exp2((s[half][1] - m0) * c) : 0.f;
          const float e10 = ok0 ? fast_exp2((s[half][2] - m1) * c) : 0.f;
          const float e11 = ok1 ? fast_exp2((s[half][3] - m1) * c) : 0.f;
          const bf16 p00 = __float2bfloat16_rn(e00);
          const bf16 p01 = __float2bfloat16_rn(e01);
          const bf16 p10 = __float2bfloat16_rn(e10);
          const bf16 p11 = __float2bfloat16_rn(e11);
          l0 += e00 + e01;
          l1 += e10 + e11;
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

  store_rows(o.head(b, h), o.sr, acc, r0, S, 1.f / l0, 1.f / l1);
  if (m != nullptr && t == 0) {
    const size_t row = ((size_t)b * H + h) * S + r0 + g;
    if (r0 + g < S) { m[row] = m0; l[row] = l0; }
    if (r0 + g + 8 < S) { m[row + 8] = m1; l[row + 8] = l1; }
  }
}

// K5: q, k, v -> o, each a [B, H, S, 64] bf16 view whose (batch, head,
// row) strides in elements are strides[3i..3i+2] for i = q, k, v, o;
// S <= 512, with l summed before rounding; m and l [B, H, S] fp32
// contiguous (the raw row max of q.k^T and the row sum of exp2((s - m)*c)),
// both null when the caller does not train.
extern "C" int unite_grouped_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* m, void* l,
                                 const long long* strides, int B, int S, int H,
                                 float c, void* stream) {
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  grouped_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), static_cast<float*>(m), static_cast<float*>(l),
      S, H, c);
  return (int)cudaGetLastError();
}
