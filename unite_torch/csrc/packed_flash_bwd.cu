// K4: packed flash attention backward for Hopper (sm_90a), any sequence
// length, as two kernels in the FlashAttention-2 split the TPU has:
//
//   K4a replaces unite_tpu/ops/attention.py::_packed_dq_kernel,
//   K4b replaces unite_tpu/ops/attention.py::_packed_dkv_kernel
//   (both called from _packed_flash_bwd).
//
// Given qkv [B, S, 3*H*D], K3's output o [B, S, H*D] and base-2 row
// log-sum-exp lse2 [B, H, S], and the cotangent do [B, S, H*D], they write
// dq, dk and dv straight into the lane slices of the packed dqkv
// [B, S, 3*H*D] (the TPU's concatenation does not survive). Per head:
//
//   K4a  delta = rowsum(do * o)              fp32 over the bf16 do and o
//        p  = exp2(q.k^T * c - lse2)         fp32, never rounded
//        dp = do.v^T
//        ds = p * (dp - delta) * scale       rounded to bf16
//        dq = ds.k
//   K4b  p^T  = exp2(k.q^T * c - lse2)       ROUNDED to bf16
//        dv   = p^T.do
//        dp^T = v.do^T
//        ds^T = p^T * (dp^T - delta) * scale rounded to bf16
//        dk   = ds^T.q
//
// The asymmetry (fp32 p on the dQ side, bf16 p^T on the dK/dV side) is the
// TPU kernels' own (:1004 against :1035) and is kept.
//
// Design. K4a: one block of 8 warps per (batch, head, 128-query tile); each
// warp keeps its 16 rows of q and do as mma A fragments, computes delta for
// them (written out for K4b) and streams K and V through shared memory in
// 64-key tiles. K4b: one block per (batch, head, 128-key tile); each warp
// keeps its 16 rows of k and v as A fragments and streams Q, dO and the
// queries' lse2 and delta through shared memory in 64-query tiles. K4b runs
// after K4a on one stream. Each stream is double-buffered: cp.async copies
// tile i+1 into shared memory while the warps compute on tile i. Partial
// tiles: missing keys get p = 0 in K4a; missing queries read as zero rows in
// K4b, which add exactly 0 to dk and dv; rows past S are never written.
// Score tiles live only in registers.
//
// What bounds it on the H100: at [8, 1568, 2304], K4a does 3 products
// (6*S^2*D flops a head, 9.1e10 in all, 0.092 ms at 989 TFLOP/s) and K4b 4
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
    packed_flash_dq_kernel(const bf16* __restrict__ qkv,
                           const bf16* __restrict__ out,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta,
                           bf16* __restrict__ dqkv, int S, int H, float c,
                           float scale) {
  __shared__ __align__(16) bf16 k_s[2][TILE];
  __shared__ __align__(16) bf16 v_s[2][TILE];

  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = H * HEAD_DIM;
  const size_t stride = 3 * (size_t)hd;
  const bf16* base = qkv + (size_t)b * S * stride;
  const bf16* k_g = base + hd + h * HEAD_DIM;
  const bf16* v_g = base + 2 * hd + h * HEAD_DIM;
  const size_t off = (size_t)b * S * hd + h * HEAD_DIM;  // o, do, head h
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
      float v = 0.f;
      if (row < S) {
        const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(
            dout + off + (size_t)row * hd)[lane];
        const __nv_bfloat162 o = reinterpret_cast<const __nv_bfloat162*>(
            out + off + (size_t)row * hd)[lane];
        v = __bfloat162float(a.x) * __bfloat162float(o.x) +
            __bfloat162float(a.y) * __bfloat162float(o.y);
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(0xffffffffu, v, sh);
      if (lane == 0 && row < S) delta[stat + row] = v;
      if (i == g) dl0 = v;
      if (i == g + 8) dl1 = v;
    }
    ls0 = r0 + g < S ? lse[stat + r0 + g] : 0.f;
    ls1 = r0 + g + 8 < S ? lse[stat + r0 + g + 8] : 0.f;
  }
  load_a_rows(qa, base + h * HEAD_DIM, stride, r0, S);
  load_a_rows(da, dout + off, hd, r0, S);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int ntiles = (S + BLOCK_T - 1) / BLOCK_T;
  load_rows_async(k_s[0], k_g, stride, min(BLOCK_T, S), BLOCK_T);
  load_rows_async(v_s[0], v_g, stride, min(BLOCK_T, S), BLOCK_T);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {  // tile i+1 streams in while tile i is used
      const int k1 = (i + 1) * BLOCK_T;
      load_rows_async(k_s[(i + 1) & 1], k_g + (size_t)k1 * stride, stride,
                      min(BLOCK_T, S - k1), BLOCK_T);
      load_rows_async(v_s[(i + 1) & 1], v_g + (size_t)k1 * stride, stride,
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
  store_rows(dqkv + (size_t)b * S * stride + h * HEAD_DIM, stride, acc, r0, S,
             1.f, 1.f);
}

__global__ void __launch_bounds__(THREADS, 2)
    packed_flash_dkv_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dqkv, int S, int H, float c,
                            float scale) {
  __shared__ __align__(16) bf16 q_s[2][TILE];
  __shared__ __align__(16) bf16 do_s[2][TILE];
  __shared__ __align__(16) float lse_s[2][BLOCK_T];
  __shared__ __align__(16) float delta_s[2][BLOCK_T];

  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = H * HEAD_DIM;
  const size_t stride = 3 * (size_t)hd;
  const bf16* base = qkv + (size_t)b * S * stride;
  const bf16* q_g = base + h * HEAD_DIM;
  const bf16* do_g = dout + (size_t)b * S * hd + h * HEAD_DIM;
  const size_t stat = ((size_t)b * H + h) * S;
  const int t = threadIdx.x & 3;
  const int j0 = blockIdx.x * BLOCK_ROWS + (threadIdx.x >> 5) * ROWS_PER_WARP;
  const bool active = j0 < S;

  // the warp's 16 keys, as left operands: s^T = k.q^T and dp^T = v.do^T
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, base + hd + h * HEAD_DIM, stride, j0, S);
  load_a_rows(va, base + 2 * hd + h * HEAD_DIM, stride, j0, S);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  // one tile of queries: their q and do rows, lse2 and delta. Missing
  // queries read zeros everywhere, and a zero q and do row adds exactly 0
  // to dk and dv (p^T = 1 multiplies do = 0; ds^T = 1*(0 - 0)*scale).
  auto load_tile = [&](int buf, int i0) {
    const int nq = min(BLOCK_T, S - i0);
    load_rows_async(q_s[buf], q_g + (size_t)i0 * stride, stride, nq, BLOCK_T);
    load_rows_async(do_s[buf], do_g + (size_t)i0 * hd, hd, nq, BLOCK_T);
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
          const int q = n0 + half * 8 + 2 * t;  // query columns q, q + 1
          const float la = ls[q], lb = ls[q + 1];
          const float da = dl[q], db = dl[q + 1];
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
        mma_p_x(dv, pa, ds, n0);
        mma_p_x(dk, dsa, qs, n0);
      });
    }
    __syncthreads();
  }
  if (!active) return;
  bf16* dst = dqkv + (size_t)b * S * stride + h * HEAD_DIM;
  store_rows(dst + hd, stride, dk, j0, S, 1.f, 1.f);
  store_rows(dst + 2 * hd, stride, dv, j0, S, 1.f, 1.f);
}

// K4a. qkv [B, S, 3*H*64], out and dout [B, S, H*64] bf16, lse [B, H, S]
// fp32 -> the q lanes of dqkv [B, S, 3*H*64] and delta [B, H, S] fp32.
// c = scale*log2(e). Launches on `stream`; returns cudaGetLastError().
extern "C" int unite_packed_flash_dq(const void* qkv, const void* out,
                                     const void* dout, const void* lse,
                                     void* delta, void* dqkv, int B, int S,
                                     int H, float c, float scale,
                                     void* stream) {
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  packed_flash_dq_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dqkv), S, H, c, scale);
  return (int)cudaGetLastError();
}

// K4b. qkv, dout, lse and K4a's delta -> the k and v lanes of dqkv.
extern "C" int unite_packed_flash_dkv(const void* qkv, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dqkv, int B, int S, int H,
                                      float c, float scale, void* stream) {
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  packed_flash_dkv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), S, H, c, scale);
  return (int)cudaGetLastError();
}
