// Grouped short-sequence attention backward (K5) for Hopper (sm_90a) over
// strided [B, H, S, 64] views, S <= 512 (the route's bound; any S works).
// Two kernels replace unite_tpu/ops/attention.py::_grouped_bwd_kernel
// (called from _grouped_attention_bwd), which computes dq, dk and dv in one
// program from the recomputed softmax.
//
// The TPU kernel's arithmetic, with its rounding points, per head:
//
//   e      = exp2((s - m)*c), s = q.k^T     fp32, m the exact row max
//   inv_l  = 1 / rowsum(e)
//   dv     = bf16(e)^T . bf16(do * inv_l)
//   dp     = do.v^T                          fp32
//   delta  = rowsum(e * dp) * inv_l
//   ds     = e * (dp - delta)                fp32, unnormalised
//   dq     = bf16(ds) . k * (scale * inv_l)
//   dk     = bf16(ds * inv_l)^T . q * scale
//
// This differs from the flash backward (K2, K4, K6) in where it normalises:
// those round p = e/l before the products, here e stays unnormalised and
// 1/l multiplies the [S, D] side, so K5 cannot reuse their kernels. m and l
// come from the K5 forward (unite_grouped_fwd), which takes the exact row
// max; e is recomputed against it, as the TPU kernel recomputes it.
//
// Design. The TPU kernel keeps G heads' [S, S] tiles in VMEM. A block here
// cannot: a fused (batch, head) block holding q, k, v and do at S = 512
// needs 4*512*64*2 = 256 KB of shared memory, over the 227 KB a block may
// have. So the backward is split as the flash kernels split it:
//
//   dq:  one block of 8 warps per (batch, head, 128-query tile); each warp
//        keeps its 16 rows of q and do as mma A fragments, and K and V
//        stream through shared memory in 64-key tiles, twice: sweep 1 sums
//        e*dp for delta (written out for the dkv kernel), sweep 2 forms ds
//        and accumulates ds.k;
//   dkv: one block per (batch, head, 128-key tile); each warp keeps its 16
//        rows of k and v as A fragments, and Q, dO and the queries' m, l and
//        delta stream in 64-query tiles. Each tile's bf16(do * inv_l) is
//        formed once in shared memory for the dv product.
//
// cp.async double-buffers every stream. Partial tiles: missing keys get
// e = 0 in dq; missing queries read zero rows and get inv_l = 0 in dkv, so
// they add exactly 0 to dk and dv; rows past S are never written.
//
// What bounds it on the H100: at the stage-1 mask-0.75 shape
// [64, 12, 392, 64] the five products of the function are 10*S^2*D flops a
// head (0.076 ms at 989 TFLOP/s); the kernels do 9 (dq: q.k^T and do.v^T
// twice, ds.k; dkv: k.q^T, v.do^T, the dv and dk products), against 7 bf16
// tensors of 38.5 MB read or written (0.080 ms at 3.35 TB/s). Products are
// mma.sync (wgmma and TMA are later work); exp2 runs on the special-function
// unit with denormal results flushed to 0.
#include "fused_qkv_common.cuh"

using namespace unite;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_ROWS = WARPS * ROWS_PER_WARP;  // 128 rows a block
constexpr int BLOCK_T = 64;                         // streamed rows a tile
constexpr int TILE = BLOCK_T * PITCH;               // elements of one buffer

__global__ void __launch_bounds__(THREADS, 2)
    grouped_dq_kernel(View q, View k, View v, View dout,
                      const float* __restrict__ mrow,
                      const float* __restrict__ lrow,
                      float* __restrict__ delta, View dq, int S, int H,
                      float c, float scale) {
  __shared__ __align__(16) bf16 k_s[2][TILE];
  __shared__ __align__(16) bf16 v_s[2][TILE];

  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* k_g = k.head(b, h);
  const bf16* v_g = v.head(b, h);
  const size_t ks_r = k.sr, vs_r = v.sr;
  const size_t stat = ((size_t)b * H + h) * S;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BLOCK_ROWS + (threadIdx.x >> 5) * ROWS_PER_WARP;
  const bool active = r0 < S;
  const bool v0 = r0 + g < S, v1 = r0 + g + 8 < S;
  const float m0 = v0 ? mrow[stat + r0 + g] : 0.f;
  const float m1 = v1 ? mrow[stat + r0 + g + 8] : 0.f;
  const float il0 = v0 ? 1.f / lrow[stat + r0 + g] : 0.f;
  const float il1 = v1 ? 1.f / lrow[stat + r0 + g + 8] : 0.f;

  uint32_t qa[4][4], da[4][4];
  load_a_rows(qa, q.head(b, h), q.sr, r0, S);
  load_a_rows(da, dout.head(b, h), dout.sr, r0, S);
  const int ntiles = (S + BLOCK_T - 1) / BLOCK_T;

  // One sweep over the K/V tiles; step(n0, nk, s, dp, key) sees the 16x8
  // score and dp tiles of keys n0 + half*8 (C fragment layout).
  auto sweep = [&](auto&& step) {
    load_rows_async(k_s[0], k_g, ks_r, min(BLOCK_T, S), BLOCK_T);
    load_rows_async(v_s[0], v_g, vs_r, min(BLOCK_T, S), BLOCK_T);
    cp_async_commit();
    for (int i = 0; i < ntiles; ++i) {
      if (i + 1 < ntiles) {
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
      if (active) step(k_s[i & 1], v_s[i & 1], nk);
      __syncthreads();  // tile i's buffers are free for tile i+2
    }
  };
  // e of one 16x8 score tile, masked past the valid keys
  auto exps = [&](float (&e)[4], const float (&s)[4], int key, int nk) {
    const bool ok0 = key < nk, ok1 = key + 1 < nk;
    e[0] = ok0 ? fast_exp2((s[0] - m0) * c) : 0.f;
    e[1] = ok1 ? fast_exp2((s[1] - m0) * c) : 0.f;
    e[2] = ok0 ? fast_exp2((s[2] - m1) * c) : 0.f;
    e[3] = ok1 ? fast_exp2((s[3] - m1) * c) : 0.f;
  };

  // sweep 1: delta = rowsum(e * dp) * inv_l
  float sd0 = 0.f, sd1 = 0.f;
  sweep([&](const bf16* ks, const bf16* vs, int nk) {
    for_steps<BLOCK_T>(nk, [&](int n0, int nk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, e[4];
        mma_rows_t(s, qa, ks, n0 + half * 8);
        mma_rows_t(dp, da, vs, n0 + half * 8);
        exps(e, s, n0 + half * 8 + 2 * t, nk);
        sd0 += e[0] * dp[0] + e[1] * dp[1];
        sd1 += e[2] * dp[2] + e[3] * dp[3];
      }
    });
  });
  const float dl0 = quad_sum(sd0) * il0, dl1 = quad_sum(sd1) * il1;
  if (active && t == 0) {
    if (v0) delta[stat + r0 + g] = dl0;
    if (v1) delta[stat + r0 + g + 8] = dl1;
  }

  // sweep 2: ds = e * (dp - delta) rounded, acc += ds.k
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  sweep([&](const bf16* ks, const bf16* vs, int nk) {
    for_steps<BLOCK_T>(nk, [&](int n0, int nk) {
      uint32_t dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, e[4];
        mma_rows_t(s, qa, ks, n0 + half * 8);
        mma_rows_t(dp, da, vs, n0 + half * 8);
        exps(e, s, n0 + half * 8 + 2 * t, nk);
        dsa[2 * half] = pack_f32(e[0] * (dp[0] - dl0), e[1] * (dp[1] - dl0));
        dsa[2 * half + 1] =
            pack_f32(e[2] * (dp[2] - dl1), e[3] * (dp[3] - dl1));
      }
      mma_p_x(acc, dsa, ks, n0);
    });
  });
  if (!active) return;
  store_rows(dq.head(b, h), dq.sr, acc, r0, S, scale * il0, scale * il1);
}

__global__ void __launch_bounds__(THREADS, 2)
    grouped_dkv_kernel(View q, View k, View v, View dout,
                       const float* __restrict__ mrow,
                       const float* __restrict__ lrow,
                       const float* __restrict__ delta, View dk, View dv_out,
                       int S, int H, float c, float scale) {
  __shared__ __align__(16) bf16 q_s[2][TILE];
  __shared__ __align__(16) bf16 do_s[2][TILE];
  __shared__ __align__(16) bf16 dol_s[TILE];  // bf16(do * inv_l), one tile
  __shared__ __align__(16) float m_s[2][BLOCK_T];
  __shared__ __align__(16) float l_s[2][BLOCK_T];
  __shared__ __align__(16) float delta_s[2][BLOCK_T];
  __shared__ float il_s[BLOCK_T];

  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q_g = q.head(b, h);
  const bf16* do_g = dout.head(b, h);
  const size_t qs_r = q.sr, dos_r = dout.sr;
  const size_t stat = ((size_t)b * H + h) * S;
  const int t = threadIdx.x & 3;
  const int j0 = blockIdx.x * BLOCK_ROWS + (threadIdx.x >> 5) * ROWS_PER_WARP;
  const bool active = j0 < S;

  // the warp's 16 keys as left operands: s^T = k.q^T and dp^T = v.do^T
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k.head(b, h), k.sr, j0, S);
  load_a_rows(va, v.head(b, h), v.sr, j0, S);

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  // one tile of queries: q and do rows and the rows' m, l and delta;
  // missing queries read zeros everywhere
  auto load_tile = [&](int buf, int i0) {
    const int nq = min(BLOCK_T, S - i0);
    load_rows_async(q_s[buf], q_g + (size_t)i0 * qs_r, qs_r, nq, BLOCK_T);
    load_rows_async(do_s[buf], do_g + (size_t)i0 * dos_r, dos_r, nq, BLOCK_T);
    const int i = threadIdx.x & (BLOCK_T - 1);
    const bool ok = i < nq;
    const size_t at = stat + i0 + (ok ? i : 0);
    if (threadIdx.x < BLOCK_T) cp_async4(&m_s[buf][i], mrow + at, ok);
    else if (threadIdx.x < 2 * BLOCK_T) cp_async4(&l_s[buf][i], lrow + at, ok);
    else if (threadIdx.x < 3 * BLOCK_T)
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
    const int buf = it & 1;
    const int nq = min(BLOCK_T, S - it * BLOCK_T);
    if (threadIdx.x < BLOCK_T)
      il_s[threadIdx.x] = threadIdx.x < nq ? 1.f / l_s[buf][threadIdx.x] : 0.f;
    __syncthreads();
    // bf16(do * inv_l), 8 lanes of a row at a time
    for (int idx = threadIdx.x; idx < BLOCK_T * 8; idx += THREADS) {
      const int r = idx >> 3, col = (idx & 7) * 8;
      const float il = il_s[r];
      const bf16* src = do_s[buf] + r * PITCH + col;
      uint4 packed;
      uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = pack_f32(__bfloat162float(src[2 * e]) * il,
                        __bfloat162float(src[2 * e + 1]) * il);
      *reinterpret_cast<uint4*>(dol_s + r * PITCH + col) = packed;
    }
    __syncthreads();
    const bf16* qs = q_s[buf];
    const bf16* ds = do_s[buf];
    const float* ms = m_s[buf];
    const float* dl = delta_s[buf];
    if (active) {
      for_steps<BLOCK_T>(nq, [&](int n0, int) {
        uint32_t ea[4], dsa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows_t(s, ka, qs, n0 + half * 8);
          mma_rows_t(dp, va, ds, n0 + half * 8);
          const int qi = n0 + half * 8 + 2 * t;  // query columns qi, qi + 1
          const float ma = ms[qi], mb = ms[qi + 1];
          const float da = dl[qi], db = dl[qi + 1];
          const float ia = il_s[qi], ib = il_s[qi + 1];
          const float e00 = fast_exp2((s[0] - ma) * c);  // key g
          const float e01 = fast_exp2((s[1] - mb) * c);
          const float e10 = fast_exp2((s[2] - ma) * c);  // key g + 8
          const float e11 = fast_exp2((s[3] - mb) * c);
          ea[2 * half] = pack_f32(e00, e01);
          ea[2 * half + 1] = pack_f32(e10, e11);
          dsa[2 * half] = pack_f32(e00 * (dp[0] - da) * ia,
                                   e01 * (dp[1] - db) * ib);
          dsa[2 * half + 1] = pack_f32(e10 * (dp[2] - da) * ia,
                                       e11 * (dp[3] - db) * ib);
        }
        mma_p_x(dv_acc, ea, dol_s, n0);
        mma_p_x(dk_acc, dsa, qs, n0);
      });
    }
    __syncthreads();
  }
  if (!active) return;
  store_rows(dk.head(b, h), dk.sr, dk_acc, j0, S, scale, scale);
  store_rows(dv_out.head(b, h), dv_out.sr, dv_acc, j0, S, 1.f, 1.f);
}

// dq and delta. q, k, v, do and dq are [B, H, S, 64] bf16 views whose
// (batch, head, row) strides are strides[3i..3i+2] in that order; m and l
// (in, from unite_grouped_fwd) and delta (out) [B, H, S] fp32 contiguous.
// c = scale*log2(e). Launches on `stream`; returns cudaGetLastError().
extern "C" int unite_grouped_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* m,
                                const void* l, void* delta, void* dq,
                                const long long* strides, int B, int S, int H,
                                float c, float scale, void* stream) {
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  grouped_dq_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(dout, strides, 3), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(delta),
      view_of(dq, strides, 4), S, H, c, scale);
  return (int)cudaGetLastError();
}

// dk and dv from q, k, v, do, m, l and the dq kernel's delta. Views q, k, v,
// do, dk, dv with strides[3i..3i+2] in that order.
extern "C" int unite_grouped_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* m,
                                 const void* l, const void* delta, void* dk,
                                 void* dv, const long long* strides, int B,
                                 int S, int H, float c, float scale,
                                 void* stream) {
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  grouped_dkv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(dout, strides, 3), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(delta),
      view_of(dk, strides, 4), view_of(dv, strides, 5), S, H, c, scale);
  return (int)cudaGetLastError();
}
