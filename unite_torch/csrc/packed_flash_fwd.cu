// Flash attention forward for Hopper (sm_90a) over strided [B, H, S, 64]
// views, any sequence length. One kernel body serves three TPU kernels:
//
//   K3 replaces unite_tpu/ops/attention.py::_packed_fwd_kernel (called from
//      _packed_flash_fwd): q, k, v are lane slices of the packed qkv
//      [B, S, 3*H*D] and o is written into [B, S, H*D], with strides (no
//      head split or merge in device memory);
//   K6 replaces unite_tpu/ops/attention.py::_fwd_kernel (called from
//      _flash_fwd): q, k, v and o are [B, H, S, D] tensors, contiguous or
//      strided views of the qkv projection's output (the models' route for
//      lengths with no divisor block, e.g. 1569 = 1568 patches + CLS);
//   K5 replaces unite_tpu/ops/attention.py::_grouped_fwd_kernel (called from
//      _grouped_attention_fwd): [B, H, S, D] views at S <= 512, the models'
//      route for training at 385-512 tokens (392 = stage 1 at mask 0.75)
//      and for widths that are not a multiple of 128. Template GROUPED.
//
// Per head: o = softmax(q.k^T * scale) . v, plus the base-2 row
// log-sum-exp lse2 = m*c + log2(l), [B, H, S] fp32, when the caller trains
// (the backward kernels read it).
//
// Contract kept from the TPU kernels: bf16 operands, fp32 accumulation, the
// scale folded into exp2 as c = scale*log2(e), and p = exp2((s - m)*c)
// rounded to bf16 against the EXACT global row max m before the p.v product;
// l = rowsum of the rounded p; o = (p.v) * (1/l). K5 (GROUPED) differs in
// one rounding point: its l is the row sum of the fp32 e = exp2((s - m)*c)
// BEFORE the rounding (_grouped_fwd_kernel :459), and it saves the raw row
// max m and that l ([B, H, S] fp32 each) for its backward, which recomputes
// e against the exact m. An online-softmax rescale
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
// 12*128 + 32 queries; 1569 = 24*64 + 33 and 12*128 + 33): missing key rows
// are zero-filled and get p = 0, missing query rows are computed on zeros
// and never written.
//
// What bounds it on the H100: at [8, 1568, 2304] the attention is 6.0e10
// flops (0.061 ms at 989 TFLOP/s) against 77 MB of qkv read and o written
// (0.023 ms at 3.35 TB/s), so it is bound by operations. The tiles of a
// (batch, head) are neighbours in the grid, so a head's K and V come from L2
// after the first tile reads them. Each stream is double-buffered: cp.async
// copies tile i+1 into shared memory while the warps compute on tile i. The
// products are mma.sync (wgmma and TMA are later work), and exp2 runs on the
// special-function unit with denormal results flushed to 0. K5 at the
// stage-1 mask-0.75 shape [64, 12, 392, 64] moves 38.5 MB a tensor (q, k,
// v, o: 0.046 ms at 3.35 TB/s) against 3.0e10 flops of attention (0.031 ms
// at 989 TFLOP/s), so it is bound by bytes; its 392 keys take 7 tiles, the
// last one 8 keys long, and the 4 query tiles of a head read K and V from
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

// GROUPED = false (K3, K6): stat0 is lse2 or null, stat1 unused.
// GROUPED = true (K5): stat0 = m and stat1 = l, both null or both set.
template <bool GROUPED>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_kernel(View q, View k, View v, View o,
                     float* __restrict__ stat0, float* __restrict__ stat1,
                     int S, int H, float c) {
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

  // sweep 2: p = exp2((s - m)*c) rounded to bf16, l = rowsum(p) (K5: of
  // the fp32 e before rounding), acc = p.v
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
          if (GROUPED) {
            l0 += e00 + e01;
            l1 += e10 + e11;
          } else {
            l0 += __bfloat162float(p00) + __bfloat162float(p01);
            l1 += __bfloat162float(p10) + __bfloat162float(p11);
          }
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
  if (stat0 != nullptr && t == 0) {
    const size_t row = ((size_t)b * H + h) * S + r0 + g;
    if (GROUPED) {
      if (r0 + g < S) { stat0[row] = m0; stat1[row] = l0; }
      if (r0 + g + 8 < S) { stat0[row + 8] = m1; stat1[row + 8] = l1; }
    } else {
      if (r0 + g < S) stat0[row] = m0 * c + log2f(l0);
      if (r0 + g + 8 < S) stat0[row + 8] = m1 * c + log2f(l1);
    }
  }
}

// q, k, v -> o, each a [B, H, S, 64] bf16 view whose (batch, head, row)
// strides in elements are strides[3i..3i+2] for i = q, k, v, o; lse
// [B, H, S] fp32 contiguous, or null. c = scale*log2(e). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int unite_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const long long* strides,
                               int B, int S, int H, float c, void* stream) {
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  flash_fwd_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), static_cast<float*>(lse), nullptr, S, H, c);
  return (int)cudaGetLastError();
}

// K5: q, k, v -> o as above, S <= 512, with l summed before rounding; m
// and l [B, H, S] fp32 contiguous (the raw row max of q.k^T and the row sum
// of exp2((s - m)*c)), both null when the caller does not train.
extern "C" int unite_grouped_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* m, void* l,
                                 const long long* strides, int B, int S, int H,
                                 float c, void* stream) {
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  flash_fwd_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), static_cast<float*>(m), static_cast<float*>(l),
      S, H, c);
  return (int)cudaGetLastError();
}
