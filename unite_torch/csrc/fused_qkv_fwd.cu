// K1: fused-qkv attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel unite_tpu/ops/attention.py::_fused_qkv_kernel
// (called from _fused_qkv_fwd). Per head: o = softmax(q.k^T * scale) . v,
// read from and written to the packed layouts [B, S, 3*H*D] -> [B, S, H*D].
//
// Contract kept from the TPU kernel: bf16 operands with fp32 accumulation;
// the scale folded into exp2 as c = scale*log2(e); an exact full-row softmax
// with the fp32 global row max; p = exp2((s - m)*c) rounded to bf16 before
// the p.v product; l = rowsum of the rounded p; o = (p.v) * (1/l). When the
// caller trains, the base-2 log-sum-exp of the scaled scores,
// lse2 = m*c + log2(l), is written per (batch, head, row) for the backward.
//
// What bounds it on the H100: at the main-path shapes (S = 197 teacher,
// 320 student, D = 64) the work is ~4*S*D flops per byte of qkv read, about
// 100 flop/byte, below the card's ~295 flop/byte ridge: it is bound by the
// bytes of qkv read and of o written. The design therefore reads qkv once:
// one block per (batch, head) copies the head's K and V into shared memory
// (2*S*64*2 bytes: 50 KB at 197, 80 KB at 320) and its 8 warps walk the
// head's 16-query tiles, so no score ever leaves the SM and K/V are fetched
// once per head, not once per query tile. Right operands come out of shared
// memory through ldmatrix. The exact global row max costs a second q.k^T
// sweep (pass 1: max, pass 2: exp, sum, p.v); that is tensor-core work the
// memory bound leaves room for, and it keeps the TPU kernel's rounding.
// Sequence length is bounded by shared memory: the wrapper refuses S > 768
// (the blocked long-sequence kernel, K3, is the route there).
#include "fused_qkv_common.cuh"

using namespace unite;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// One warp's 16 query rows r0.. of head h: o rows and, when lse is not
// null, their lse2.
__device__ __forceinline__ void fwd_rows(const bf16* q, size_t stride,
                                         const bf16* k_s, const bf16* v_s,
                                         bf16* o, size_t o_stride,
                                         float* lse_row, int r0, int S,
                                         float c) {
  const int S16 = round16(S);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t qa[4][4];
  load_a_rows(qa, q, stride, r0, S);

  // pass 1: the exact row max over every valid key, two key tiles (two
  // independent accumulator chains) at a time
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int n0 = 0; n0 < S16; n0 += 16) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mma_rows_t(s[0], qa, k_s, n0);
    mma_rows_t(s[1], qa, k_s, n0 + 8);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = n0 + half * 8 + 2 * t;
      if (key < S) { m0 = fmaxf(m0, s[half][0]); m1 = fmaxf(m1, s[half][2]); }
      if (key + 1 < S) { m0 = fmaxf(m0, s[half][1]); m1 = fmaxf(m1, s[half][3]); }
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  // pass 2: p = exp2((s - m)*c) rounded to bf16, l = rowsum(p), acc = p.v
  float l0 = 0.f, l1 = 0.f;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < S16; k0 += 16) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mma_rows_t(s[0], qa, k_s, k0);
    mma_rows_t(s[1], qa, k_s, k0 + 8);
    uint32_t pa[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + half * 8 + 2 * t;
      const bool ok0 = key < S, ok1 = key + 1 < S;
      const bf16 p00 = __float2bfloat16_rn(ok0 ? exp2f((s[half][0] - m0) * c) : 0.f);
      const bf16 p01 = __float2bfloat16_rn(ok1 ? exp2f((s[half][1] - m0) * c) : 0.f);
      const bf16 p10 = __float2bfloat16_rn(ok0 ? exp2f((s[half][2] - m1) * c) : 0.f);
      const bf16 p11 = __float2bfloat16_rn(ok1 ? exp2f((s[half][3] - m1) * c) : 0.f);
      l0 += __bfloat162float(p00) + __bfloat162float(p01);
      l1 += __bfloat162float(p10) + __bfloat162float(p11);
      pa[2 * half] = pack_raw(p00, p01);      // row g
      pa[2 * half + 1] = pack_raw(p10, p11);  // row g + 8
    }
    mma_p_x(acc, pa, v_s, k0);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  store_rows(o, o_stride, acc, r0, S, 1.f / l0, 1.f / l1);
  if (lse_row != nullptr && t == 0) {
    if (r0 + g < S) lse_row[r0 + g] = m0 * c + log2f(l0);
    if (r0 + g + 8 < S) lse_row[r0 + g + 8] = m1 * c + log2f(l1);
  }
}

// At most 85 registers, so three blocks of 8 warps share an SM at S = 197
// (60 KB of shared memory each); uncapped it took 100 and fit two.
__global__ void __launch_bounds__(THREADS, 3)
    fused_qkv_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, int H, float c) {
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

  float* lse_row = lse != nullptr ? lse + ((size_t)b * H + h) * S : nullptr;
  const int warp = threadIdx.x >> 5;
  for (int r0 = warp * ROWS_PER_WARP; r0 < S; r0 += WARPS * ROWS_PER_WARP)
    fwd_rows(base + h * HEAD_DIM, stride, k_s, v_s,
             out + (size_t)b * S * hd + h * HEAD_DIM, hd, lse_row, r0, S, c);
}

// qkv [B, S, 3*H*64] bf16 -> out [B, S, H*64] bf16, lse [B, H, S] fp32 (or
// null). c = scale*log2(e). Launches on `stream`; returns cudaGetLastError().
extern "C" int unite_fused_qkv_fwd(const void* qkv, void* out, void* lse,
                                   int B, int S, int H, float c,
                                   void* stream) {
  const size_t smem = 2 * (size_t)round16(S) * PITCH * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_qkv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  fused_qkv_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, H, c);
  return (int)cudaGetLastError();
}
