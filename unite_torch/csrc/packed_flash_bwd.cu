// Flash attention backward for Hopper (sm_90a) over strided [B, H, S, 64]
// views, any sequence length, as two kernels in the FlashAttention-2 split
// the TPU has. They serve two TPU kernel pairs:
//
//   K4a replaces unite_tpu/ops/attention.py::_packed_dq_kernel,
//   K4b replaces unite_tpu/ops/attention.py::_packed_dkv_kernel
//   (both called from _packed_flash_bwd): q, k, v, o and do are lane slices
//   of the packed [B, S, 3*H*D] and [B, S, H*D] layouts, and dq, dk, dv are
//   written straight into the lane slices of the packed dqkv (the TPU's
//   concatenation does not survive);
//   K6 dq replaces unite_tpu/ops/attention.py::_bwd_dq_kernel,
//   K6 dkv replaces unite_tpu/ops/attention.py::_bwd_dkv_kernel
//   (both called from _flash_bwd): every tensor is a [B, H, S, D] view.
//
// Given q, k, v, the forward's output o and base-2 row log-sum-exp lse2
// [B, H, S], and the cotangent do, per head:
//
//   dq   delta = rowsum(do * o)              fp32 over the bf16 do and o
//        p  = exp2(q.k^T * c - lse2)         fp32, never rounded
//        dp = do.v^T
//        ds = p * (dp - delta) * scale       rounded to bf16
//        dq = ds.k
//   dkv  p^T  = exp2(k.q^T * c - lse2)       ROUNDED to bf16
//        dv   = p^T.do
//        dp^T = v.do^T
//        ds^T = p^T * (dp^T - delta) * scale rounded to bf16
//        dk   = ds^T.q
//
// The asymmetry (fp32 p on the dQ side, bf16 p^T on the dK/dV side) is the
// TPU kernels' own (:263 and :1004 against :289 and :1035) and is kept.
//
// Design. dq: one block of 8 warps per (batch, head, 128-query tile); each
// warp keeps its 16 rows of q and do as mma A fragments, computes delta for
// them (written out for the dkv kernel) and streams K and V through shared
// memory in 64-key tiles. dkv: one block per (batch, head, 128-key tile);
// each warp keeps its 16 rows of k and v as A fragments and streams Q, dO
// and the queries' lse2 and delta through shared memory in 64-query tiles.
// dkv runs after dq on one stream. Each stream is double-buffered: cp.async
// copies tile i+1 into shared memory while the warps compute on tile i.
// Partial tiles: missing keys get p = 0 in dq; missing queries read as zero
// rows in dkv, which add exactly 0 to dk and dv; rows past S are never
// written. Score tiles live only in registers.
//
// What bounds it on the H100: at [8, 1568, 2304], dq does 3 products
// (6*S^2*D flops a head, 9.1e10 in all, 0.092 ms at 989 TFLOP/s) and dkv 4
// (8*S^2*D, 0.122 ms), against 0.02-0.03 ms of bytes each: both are bound
// by operations. The products are mma.sync (wgmma and TMA are later work),
// and exp2 runs on the special-function unit with denormals flushed to 0.
#include "fused_qkv_common.cuh"

using namespace unite;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_ROWS = WARPS * ROWS_PER_WARP;  // 128 rows a block
constexpr int BLOCK_T = 64;                         // streamed rows a tile
constexpr int TILE = BLOCK_T * PITCH;               // elements of one buffer

__global__ void __launch_bounds__(THREADS, 2)
    flash_dq_kernel(View q, View k, View v, View o, View dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    View dq, int S, int H, float c, float scale) {
  __shared__ __align__(16) bf16 k_s[2][TILE];
  __shared__ __align__(16) bf16 v_s[2][TILE];

  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* k_g = k.head(b, h);
  const bf16* v_g = v.head(b, h);
  const bf16* o_h = o.head(b, h);
  const bf16* do_h = dout.head(b, h);
  const size_t ks_r = k.sr, vs_r = v.sr;
  const size_t stat = ((size_t)b * H + h) * S;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BLOCK_ROWS + (threadIdx.x >> 5) * ROWS_PER_WARP;
  const bool active = r0 < S;

  // delta = rowsum(do * o) for the warp's 16 rows, one row a sweep
  float dl0 = 0.f, dl1 = 0.f, ls0 = 0.f, ls1 = 0.f;
  uint32_t qa[4][4], da[4][4];
  if (active) {
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int row = r0 + i;
      float x = 0.f;
      if (row < S) {
        const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(
            do_h + (size_t)row * dout.sr)[lane];
        const __nv_bfloat162 y = reinterpret_cast<const __nv_bfloat162*>(
            o_h + (size_t)row * o.sr)[lane];
        x = __bfloat162float(a.x) * __bfloat162float(y.x) +
            __bfloat162float(a.y) * __bfloat162float(y.y);
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) x += __shfl_xor_sync(0xffffffffu, x, sh);
      if (lane == 0 && row < S) delta[stat + row] = x;
      if (i == g) dl0 = x;
      if (i == g + 8) dl1 = x;
    }
    ls0 = r0 + g < S ? lse[stat + r0 + g] : 0.f;
    ls1 = r0 + g + 8 < S ? lse[stat + r0 + g + 8] : 0.f;
  }
  load_a_rows(qa, q.head(b, h), q.sr, r0, S);
  load_a_rows(da, do_h, dout.sr, r0, S);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int ntiles = (S + BLOCK_T - 1) / BLOCK_T;
  load_rows_async(k_s[0], k_g, ks_r, min(BLOCK_T, S), BLOCK_T);
  load_rows_async(v_s[0], v_g, vs_r, min(BLOCK_T, S), BLOCK_T);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {  // tile i+1 streams in while tile i is used
      const int k1 = (i + 1) * BLOCK_T;
      load_rows_async(k_s[(i + 1) & 1], k_g + (size_t)k1 * ks_r, ks_r,
                      min(BLOCK_T, S - k1), BLOCK_T);
      load_rows_async(v_s[(i + 1) & 1], v_g + (size_t)k1 * vs_r, vs_r,
                      min(BLOCK_T, S - k1), BLOCK_T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int nk = min(BLOCK_T, S - i * BLOCK_T);
    const bf16* ks = k_s[i & 1];
    const bf16* vs = v_s[i & 1];
    if (active) {
      for_steps<BLOCK_T>(nk, [&](int n0, int nk) {
        uint32_t dsa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows_t(s, qa, ks, n0 + half * 8);
          mma_rows_t(dp, da, vs, n0 + half * 8);
          const int key = n0 + half * 8 + 2 * t;
          const bool ok0 = key < nk, ok1 = key + 1 < nk;
          const float p00 = ok0 ? fast_exp2(s[0] * c - ls0) : 0.f;
          const float p01 = ok1 ? fast_exp2(s[1] * c - ls0) : 0.f;
          const float p10 = ok0 ? fast_exp2(s[2] * c - ls1) : 0.f;
          const float p11 = ok1 ? fast_exp2(s[3] * c - ls1) : 0.f;
          dsa[2 * half] = pack_f32(p00 * (dp[0] - dl0) * scale,
                                   p01 * (dp[1] - dl0) * scale);
          dsa[2 * half + 1] = pack_f32(p10 * (dp[2] - dl1) * scale,
                                       p11 * (dp[3] - dl1) * scale);
        }
        mma_p_x(acc, dsa, ks, n0);
      });
    }
    __syncthreads();  // tile i's buffers are free for tile i+2
  }
  if (!active) return;
  store_rows(dq.head(b, h), dq.sr, acc, r0, S, 1.f, 1.f);
}

__global__ void __launch_bounds__(THREADS, 2)
    flash_dkv_kernel(View q, View k, View v, View dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, View dk, View dv_out,
                     int S, int H, float c, float scale) {
  __shared__ __align__(16) bf16 q_s[2][TILE];
  __shared__ __align__(16) bf16 do_s[2][TILE];
  __shared__ __align__(16) float lse_s[2][BLOCK_T];
  __shared__ __align__(16) float delta_s[2][BLOCK_T];

  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q_g = q.head(b, h);
  const bf16* do_g = dout.head(b, h);
  const size_t qs_r = q.sr, dos_r = dout.sr;
  const size_t stat = ((size_t)b * H + h) * S;
  const int t = threadIdx.x & 3;
  const int j0 = blockIdx.x * BLOCK_ROWS + (threadIdx.x >> 5) * ROWS_PER_WARP;
  const bool active = j0 < S;

  // the warp's 16 keys, as left operands: s^T = k.q^T and dp^T = v.do^T
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k.head(b, h), k.sr, j0, S);
  load_a_rows(va, v.head(b, h), v.sr, j0, S);

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  // one tile of queries: their q and do rows, lse2 and delta. Missing
  // queries read zeros everywhere, and a zero q and do row adds exactly 0
  // to dk and dv (p^T = 1 multiplies do = 0; ds^T = 1*(0 - 0)*scale).
  auto load_tile = [&](int buf, int i0) {
    const int nq = min(BLOCK_T, S - i0);
    load_rows_async(q_s[buf], q_g + (size_t)i0 * qs_r, qs_r, nq, BLOCK_T);
    load_rows_async(do_s[buf], do_g + (size_t)i0 * dos_r, dos_r, nq, BLOCK_T);
    const int i = threadIdx.x & (BLOCK_T - 1);
    const bool ok = i < nq;
    const size_t at = stat + i0 + (ok ? i : 0);
    if (threadIdx.x < BLOCK_T) cp_async4(&lse_s[buf][i], lse + at, ok);
    else if (threadIdx.x < 2 * BLOCK_T)
      cp_async4(&delta_s[buf][i], delta + at, ok);
  };
  const int ntiles = (S + BLOCK_T - 1) / BLOCK_T;
  load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_tile((it + 1) & 1, (it + 1) * BLOCK_T);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int nq = min(BLOCK_T, S - it * BLOCK_T);
    const bf16* qs = q_s[it & 1];
    const bf16* ds = do_s[it & 1];
    const float* ls = lse_s[it & 1];
    const float* dl = delta_s[it & 1];
    if (active) {
      for_steps<BLOCK_T>(nq, [&](int n0, int) {
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows_t(s, ka, qs, n0 + half * 8);
          mma_rows_t(dp, va, ds, n0 + half * 8);
          const int qi = n0 + half * 8 + 2 * t;  // query columns qi, qi + 1
          const float la = ls[qi], lb = ls[qi + 1];
          const float da = dl[qi], db = dl[qi + 1];
          const bf16 p00 = __float2bfloat16_rn(fast_exp2(s[0] * c - la));
          const bf16 p01 = __float2bfloat16_rn(fast_exp2(s[1] * c - lb));
          const bf16 p10 = __float2bfloat16_rn(fast_exp2(s[2] * c - la));
          const bf16 p11 = __float2bfloat16_rn(fast_exp2(s[3] * c - lb));
          pa[2 * half] = pack_raw(p00, p01);      // key g
          pa[2 * half + 1] = pack_raw(p10, p11);  // key g + 8
          dsa[2 * half] =
              pack_f32(__bfloat162float(p00) * (dp[0] - da) * scale,
                       __bfloat162float(p01) * (dp[1] - db) * scale);
          dsa[2 * half + 1] =
              pack_f32(__bfloat162float(p10) * (dp[2] - da) * scale,
                       __bfloat162float(p11) * (dp[3] - db) * scale);
        }
        mma_p_x(dv_acc, pa, ds, n0);
        mma_p_x(dk_acc, dsa, qs, n0);
      });
    }
    __syncthreads();
  }
  if (!active) return;
  store_rows(dk.head(b, h), dk.sr, dk_acc, j0, S, 1.f, 1.f);
  store_rows(dv_out.head(b, h), dv_out.sr, dv_acc, j0, S, 1.f, 1.f);
}

// dq and delta. q, k, v, o, do and dq are [B, H, S, 64] bf16 views whose
// (batch, head, row) strides are strides[3i..3i+2] in that order; lse (in)
// and delta (out) [B, H, S] fp32 contiguous. c = scale*log2(e). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int unite_flash_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              const long long* strides, int B, int S, int H,
                              float c, float scale, void* stream) {
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  flash_dq_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), view_of(dout, strides, 4),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      view_of(dq, strides, 5), S, H, c, scale);
  return (int)cudaGetLastError();
}

// dk and dv from q, k, v, do, lse and the dq kernel's delta. Views q, k, v,
// do, dk, dv with strides[3i..3i+2] in that order.
extern "C" int unite_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv,
                               const long long* strides, int B, int S, int H,
                               float c, float scale, void* stream) {
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  flash_dkv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(dout, strides, 3), static_cast<const float*>(lse),
      static_cast<const float*>(delta), view_of(dk, strides, 4),
      view_of(dv, strides, 5), S, H, c, scale);
  return (int)cudaGetLastError();
}
