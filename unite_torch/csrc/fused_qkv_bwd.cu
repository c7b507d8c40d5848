// K2: fused-qkv attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel unite_tpu/ops/attention.py::_fused_qkv_bwd_kernel
// (called from _fused_qkv_bwd). Given qkv [B, S, 3*H*D], the forward's output
// o [B, S, H*D], its base-2 row log-sum-exp lse2 [B, H, S] and the cotangent
// do [B, S, H*D], it writes dq, dk and dv straight into the packed
// dqkv [B, S, 3*H*D] (same lane slices as qkv; no transposes in memory).
//
// Math, per head (p_hat the normalized probabilities):
//   p_hat = exp2(q.k^T * c - lse2)            recomputed, never stored
//   delta = rowsum(do * o)                    == rowsum(p_hat * dp)
//   dp = do.v^T, ds = p_hat * (dp - delta)
//   dv = p_hat^T.do, dq = ds.k * scale, dk = ds^T.q * scale
// with bf16 operands, fp32 accumulation, and p_hat and ds rounded to bf16
// before they enter a product, as in the TPU kernel.
//
// Design (FlashAttention-2 split). The TPU kernel holds one (batch, head)'s
// whole S x S problem per program; here one block of 8 warps that did all of
// it would need dk/dv accumulators too big for registers. Instead two
// kernels, each with one block per (batch, head) whose warps walk 16-row
// tiles:
//   * dq: the head's K and V in shared memory; a warp takes 16 query rows,
//     computes delta for them (stored for the other kernel) and their dq;
//   * dkv: the head's Q and dO, lse2 and delta in shared memory (~95 KB at
//     S = 320); a warp takes 16 keys and computes their dk and dv.
// Both are launched in that order on one stream. Every score tile lives only
// in registers. What bounds it on the H100: ~5 products of 2*S*S*D flops
// against reading qkv, o, do and writing dqkv, about 200 flop/byte at S = 320,
// below the ~295 flop/byte ridge, so it is bound by bytes; each kernel reads
// its shared operands once per head, and the right operands of every
// product come out of shared memory through ldmatrix.
#include "fused_qkv_common.cuh"

using namespace unite;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// dq and delta for one warp's 16 query rows r0.. of one head.
__device__ __forceinline__ void dq_rows(const bf16* q, size_t stride,
                                        const bf16* o_h, const bf16* do_h,
                                        size_t hd, const float* lse_h,
                                        float* delta_h, const bf16* k_s,
                                        const bf16* v_s, bf16* dq,
                                        int r0, int S, float c, float scale) {
  const int S16 = round16(S);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // delta = rowsum(do * o) for the 16 rows, one row per warp sweep
  float dl0 = 0.f, dl1 = 0.f;
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = r0 + i;
    float v = 0.f;
    if (row < S) {
      const __nv_bfloat162 a =
          reinterpret_cast<const __nv_bfloat162*>(do_h + (size_t)row * hd)[lane];
      const __nv_bfloat162 o =
          reinterpret_cast<const __nv_bfloat162*>(o_h + (size_t)row * hd)[lane];
      v = __bfloat162float(a.x) * __bfloat162float(o.x) +
          __bfloat162float(a.y) * __bfloat162float(o.y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && row < S) delta_h[row] = v;
    if (i == g) dl0 = v;
    if (i == g + 8) dl1 = v;
  }
  const float ls0 = r0 + g < S ? lse_h[r0 + g] : 0.f;
  const float ls1 = r0 + g + 8 < S ? lse_h[r0 + g + 8] : 0.f;

  uint32_t qa[4][4], da[4][4];
  load_a_rows(qa, q, stride, r0, S);
  load_a_rows(da, do_h, hd, r0, S);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < S16; k0 += 16) {
    uint32_t dsa[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows_t(s, qa, k_s, k0 + half * 8);
      mma_rows_t(dp, da, v_s, k0 + half * 8);
      const int key = k0 + half * 8 + 2 * t;
      const bool ok0 = key < S, ok1 = key + 1 < S;
      const float p00 = ok0 ? exp2f(s[0] * c - ls0) : 0.f;
      const float p01 = ok1 ? exp2f(s[1] * c - ls0) : 0.f;
      const float p10 = ok0 ? exp2f(s[2] * c - ls1) : 0.f;
      const float p11 = ok1 ? exp2f(s[3] * c - ls1) : 0.f;
      dsa[2 * half] = pack_f32(p00 * (dp[0] - dl0), p01 * (dp[1] - dl0));
      dsa[2 * half + 1] = pack_f32(p10 * (dp[2] - dl1), p11 * (dp[3] - dl1));
    }
    mma_p_x(acc, dsa, k_s, k0);
  }
  store_rows(dq, stride, acc, r0, S, scale, scale);
}

__global__ void __launch_bounds__(THREADS, 2)
    fused_qkv_bwd_dq_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ out,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta,
                            bf16* __restrict__ dqkv, int S, int H, float c,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S16 = round16(S);
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + S16 * PITCH;

  const int h = blockIdx.x, b = blockIdx.y;
  const int hd = H * HEAD_DIM;
  const size_t stride = 3 * (size_t)hd;
  const bf16* base = qkv + (size_t)b * S * stride;
  load_rows(k_s, base + hd + h * HEAD_DIM, stride, S, S16);
  load_rows(v_s, base + 2 * hd + h * HEAD_DIM, stride, S, S16);
  __syncthreads();

  const size_t stat = ((size_t)b * H + h) * S;
  const size_t off = (size_t)b * S * hd + h * HEAD_DIM;
  const int warp = threadIdx.x >> 5;
  for (int r0 = warp * ROWS_PER_WARP; r0 < S; r0 += WARPS * ROWS_PER_WARP)
    dq_rows(base + h * HEAD_DIM, stride, out + off, dout + off, hd,
            lse + stat, delta + stat, k_s, v_s,
            dqkv + (size_t)b * S * stride + h * HEAD_DIM, r0, S, c, scale);
}

// dk and dv for one warp's 16 keys j0.. of one head, from the head's Q, dO,
// lse2 and delta in shared memory.
__device__ __forceinline__ void dkv_rows(const bf16* k, const bf16* v,
                                         size_t stride, const bf16* q_s,
                                         const bf16* do_s, const float* lse_s,
                                         const float* delta_s, bf16* dk_out,
                                         bf16* dv_out, int j0, int S, float c,
                                         float scale) {
  const int S16 = round16(S);
  const int t = threadIdx.x & 3;

  // this warp's 16 keys, as left operands: s^T = k.q^T and dp^T = v.do^T
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k, stride, j0, S);
  load_a_rows(va, v, stride, j0, S);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  for (int i0 = 0; i0 < S16; i0 += 16) {
    uint32_t pa[4], dsa[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows_t(s, ka, q_s, i0 + half * 8);
      mma_rows_t(dp, va, do_s, i0 + half * 8);
      const int q = i0 + half * 8 + 2 * t;  // the two query columns q, q + 1
      const float la = lse_s[q], lb = lse_s[q + 1];
      const float da = delta_s[q], db = delta_s[q + 1];
      const float p00 = exp2f(s[0] * c - la), p01 = exp2f(s[1] * c - lb);
      const float p10 = exp2f(s[2] * c - la), p11 = exp2f(s[3] * c - lb);
      pa[2 * half] = pack_f32(p00, p01);
      pa[2 * half + 1] = pack_f32(p10, p11);
      dsa[2 * half] = pack_f32(p00 * (dp[0] - da), p01 * (dp[1] - db));
      dsa[2 * half + 1] = pack_f32(p10 * (dp[2] - da), p11 * (dp[3] - db));
    }
    mma_p_x(dv, pa, do_s, i0);
    mma_p_x(dk, dsa, q_s, i0);
  }
  store_rows(dk_out, stride, dk, j0, S, scale, scale);
  store_rows(dv_out, stride, dv, j0, S, 1.f, 1.f);
}

__global__ void __launch_bounds__(THREADS, 2)
    fused_qkv_bwd_dkv_kernel(const bf16* __restrict__ qkv,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dqkv, int S, int H, float c,
                             float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S16 = round16(S);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + S16 * PITCH;
  float* lse_s = reinterpret_cast<float*>(do_s + S16 * PITCH);
  float* delta_s = lse_s + S16;

  const int h = blockIdx.x, b = blockIdx.y;
  const int hd = H * HEAD_DIM;
  const size_t stride = 3 * (size_t)hd;
  const bf16* base = qkv + (size_t)b * S * stride;
  const size_t stat = ((size_t)b * H + h) * S;
  load_rows(q_s, base + h * HEAD_DIM, stride, S, S16);
  load_rows(do_s, dout + (size_t)b * S * hd + h * HEAD_DIM, hd, S, S16);
  for (int i = threadIdx.x; i < S16; i += THREADS) {
    // padded queries get lse2 = +inf, so their p_hat is exactly 0
    lse_s[i] = i < S ? lse[stat + i] : INFINITY;
    delta_s[i] = i < S ? delta[stat + i] : 0.f;
  }
  __syncthreads();

  bf16* dst = dqkv + (size_t)b * S * stride + h * HEAD_DIM;
  const int warp = threadIdx.x >> 5;
  for (int j0 = warp * ROWS_PER_WARP; j0 < S; j0 += WARPS * ROWS_PER_WARP)
    dkv_rows(base + hd + h * HEAD_DIM, base + 2 * hd + h * HEAD_DIM, stride,
             q_s, do_s, lse_s, delta_s, dst + hd, dst + 2 * hd, j0, S, c,
             scale);
}

// qkv [B, S, 3*H*64], out and dout [B, S, H*64] bf16, lse [B, H, S] fp32 ->
// dqkv [B, S, 3*H*64] bf16; delta [B, H, S] fp32 is scratch. c =
// scale*log2(e). Launches both kernels on `stream`; returns the first error.
extern "C" int unite_fused_qkv_bwd(const void* qkv, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dqkv, int B, int S,
                                   int H, float c, float scale,
                                   void* stream) {
  const size_t tiles = 2 * (size_t)round16(S) * PITCH * sizeof(bf16);
  const size_t smem_dkv = tiles + 2 * (size_t)round16(S) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_qkv_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_qkv_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  cudaStream_t st = (cudaStream_t)stream;
  fused_qkv_bwd_dq_kernel<<<grid, THREADS, tiles, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dqkv), S, H, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_qkv_bwd_dkv_kernel<<<grid, THREADS, smem_dkv, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), S, H, c, scale);
  return (int)cudaGetLastError();
}
