// Shared pieces of the attention kernels: fused-qkv (K1, K2) and the
// strided flash kernels (K3, K4 on the packed layout, K6 on [B, H, S, D]).
//
// Layout: qkv is the qkv projection's natural [B, S, 3*H*D] row-major bf16
// output. Head h reads q at lanes [h*D, (h+1)*D), k at +H*D, v at +2*H*D;
// the kernels index those slices with strides, so no head split/merge is
// ever materialized in device memory. D is fixed at 64 (every shipped model).
//
// Tiles are products on the tensor cores through mma.sync m16n8k16 (bf16
// operands, fp32 accumulation). Each warp owns 16 rows at a time; a K1/K2
// block holds one (batch, head) and its warps walk that head's 16-row
// tiles, a K3/K4 block one 128-row tile of a (batch, head) that streams the
// other operands through shared memory.
// Right operands come from shared memory through ldmatrix (x4, transposed
// for the p.v-type products). Fragment layouts (PTX ISA, lane = 4*g + t):
//   A 16x16: a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 8+2t..)   a3 (g+8, 8+2t..)
//   B 16x8 : b0 (k=2t..2t+1, n=g)                b1 (k=8+2t.., n=g)
//   C 16x8 : c0,c1 (g, 2t..2t+1)                 c2,c3 (g+8, 2t..2t+1)
// Two C tiles side by side (16 columns) are exactly one A fragment, which is
// how a score tile becomes the left operand of the next product in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unite {

typedef __nv_bfloat16 bf16;

constexpr int HEAD_DIM = 64;
constexpr int ROWS_PER_WARP = 16;
// Shared-memory row pitch in bf16 elements: 64 + 8 of padding (144 bytes) puts
// the eight 16-byte rows of each ldmatrix read in eight distinct bank groups.
constexpr int PITCH = HEAD_DIM + 8;

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// A [B, H, S, 64] bf16 view: element (b, h, s, d) at p[b*sb + h*sh + s*sr + d].
// Row starts are 16-byte aligned (the wrappers check it). The packed layout
// is one such view per q/k/v lane slice of qkv [B, S, 3*H*64]:
// (sb, sh, sr) = (S*3*H*64, 64, 3*H*64), and o [B, S, H*64] is
// (S*H*64, 64, H*64); a contiguous [B, H, S, 64] tensor is (H*S*64, S*64, 64).
struct View {
  bf16* p;
  long long sb, sh, sr;
  __device__ __forceinline__ bf16* head(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

// Views from the C entry points: pointer i with strides s[3i..3i+2].
inline View view_of(const void* p, const long long* s, int i) {
  return View{static_cast<bf16*>(const_cast<void*>(p)), s[3 * i], s[3 * i + 1],
              s[3 * i + 2]};
}

// Not volatile: a product has no effect beyond its outputs, so the compiler
// may interleave independent accumulator chains.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses (16-byte aligned) of matrix i, which lands in r[i]. Plain, a
// lane receives row g, elements 2t..2t+1; transposed, rows 2t..2t+1 of
// column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Two bf16 values into one 32-bit register, the lower index in the low half.
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_raw(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Sum (or max) over the four lanes of a quad, which share one fragment row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// Copy rows [0, rows_valid) of a [*, 64] bf16 head slice (row stride
// `stride` elements) into shared memory at pitch PITCH, and zero the rows up
// to rows_total so padded keys/queries read as exact zeros.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int rows_valid,
                                          int rows_total) {
  for (int idx = threadIdx.x; idx < rows_total * 8; idx += blockDim.x) {
    const int r = idx >> 3;
    const int col = (idx & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * PITCH + col) = v;
  }
}

// Asynchronous copies (cp.async, sm_80+) for the streaming kernels: a copy
// with a source size of 0 writes zeros, so missing rows read as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// load_rows with cp.async: rows [0, rows_valid) of a [*, 64] head slice
// into shared memory at pitch PITCH, zeros up to rows_total. Not complete
// until cp_async_wait and a barrier.
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                size_t stride, int rows_valid,
                                                int rows_total) {
  for (int idx = threadIdx.x; idx < rows_total * 8; idx += blockDim.x) {
    const int r = idx >> 3;
    const int col = (idx & 7) * 8;
    const bool ok = r < rows_valid;
    cp_async16(dst + r * PITCH + col, src + (ok ? (size_t)r * stride : 0) + col,
               ok);
  }
}

// Runs step(n0, nk) over the 16-row steps n0 of a streamed tile that holds
// nk <= FULL valid rows. A full tile takes an unrolled loop with a constant
// bound, so the compiler can overlap one step's products with the next
// one's exp2 and shared-memory reads; the partial last tile takes a plain
// loop.
template <int FULL, typename F>
__device__ __forceinline__ void for_steps(int nk, F&& step) {
  if (nk == FULL) {
#pragma unroll
    for (int n0 = 0; n0 < FULL; n0 += 16) step(n0, FULL);
  } else {
    for (int n0 = 0; n0 < nk; n0 += 16) step(n0, nk);
  }
}

// 2^x on the special-function unit, denormal results flushed to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragments of a 16x64 row block (rows r0.., the 64 head lanes) straight
// from device memory: a[kc] covers head lanes [16*kc, 16*kc + 16). Rows at or
// past `rows` read as zero.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4],
                                            const bf16* src, size_t stride,
                                            int r0, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool v0 = r0 + g < rows, v1 = r0 + g + 8 < rows;
  const bf16* p0 = v0 ? src + (size_t)(r0 + g) * stride : src;
  const bf16* p1 = v1 ? src + (size_t)(r0 + g + 8) * stride : src;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = v0 ? ld32(p0 + kc * 16 + 2 * t) : 0u;
    a[kc][1] = v1 ? ld32(p1 + kc * 16 + 2 * t) : 0u;
    a[kc][2] = v0 ? ld32(p0 + kc * 16 + 8 + 2 * t) : 0u;
    a[kc][3] = v1 ? ld32(p1 + kc * 16 + 8 + 2 * t) : 0u;
  }
}

// c += A(16x64 rows) . X[n0:n0+8, :]^T with X row-major in shared memory:
// the 8 columns of the 16x8 result are rows n0..n0+7 of X (keys for q.k^T,
// queries for k.q^T). One ldmatrix.x4 gives the B fragments of 32 head
// lanes: matrix i is rows n0..n0+7 at head lanes 8i..8i+7 of that half.
__device__ __forceinline__ void mma_rows_t(float (&c)[4],
                                           const uint32_t (&a)[4][4],
                                           const bf16* xs, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* row = xs + (n0 + (lane & 7)) * PITCH + (lane >> 3) * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t b[4];
    ldsm_x4(b, row + half * 32);
    mma_bf16(c, a[2 * half], b[0], b[1]);
    mma_bf16(c, a[2 * half + 1], b[2], b[3]);
  }
}

// acc[j] += P(16x16, A fragment) . X[k0:k0+16, 8j:8j+8] with X row-major in
// shared memory. The right operand is read transposed: one ldmatrix.x4.trans
// gives columns 8j..8j+15 (matrices: rows k0.., k0+8.., at columns 8j, then
// 8j+8).
__device__ __forceinline__ void mma_p_x(float (&acc)[8][4],
                                        const uint32_t (&p)[4],
                                        const bf16* xs, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* r0 =
      xs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, r0 + j * 8);
    mma_bf16(acc[j], p, b[0], b[1]);
    mma_bf16(acc[j + 1], p, b[2], b[3]);
  }
}

// Store a 16x64 fp32 accumulator, times `mul`, as bf16 rows r0.. of a
// row-major array (row stride `stride` elements); rows at or past `rows`
// are dropped.
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride,
                                           const float (&acc)[8][4], int r0,
                                           int rows, float mul0, float mul1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (ra < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)ra * stride + col) =
          pack_f32(acc[j][0] * mul0, acc[j][1] * mul0);
    if (rb < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)rb * stride + col) =
          pack_f32(acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

}  // namespace unite
