// Shared pieces of the attention kernels (the wgmma forwards K1, K3, K5 and
// K6, the flash backward K4 and K6's, and the short backward K2 and K5's):
// the bf16 type, the [B, H, S, D] views the entry points describe with
// strides, packing, quad reductions and exp2.
//
// Layout: qkv is the qkv projection's natural [B, S, 3*H*D] row-major bf16
// output. Head h reads q at lanes [h*D, (h+1)*D), k at +H*D, v at +2*H*D;
// the kernels index those slices with strides, so no head split/merge is
// ever materialized in device memory. D is 64 (the ViT-B/L students, the
// CLIP teachers, VideoMAE base) or 80 (VideoMAE huge: 1280 wide with 16
// heads, its decoder 640 wide with 8); every kernel, K1-K6, is built for
// both.
//
// Accumulator and A-fragment layouts of the tensor-core products (PTX ISA,
// lane = 4*g + t, per warp of 16 rows):
//   A 16x16: a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 8+2t..)   a3 (g+8, 8+2t..)
//   C 16x8 : c0,c1 (g, 2t..2t+1)                 c2,c3 (g+8, 2t..2t+1)
// Two C tiles side by side (16 columns) are exactly one A fragment, which is
// how a score tile becomes the left operand of the next product in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unite {

typedef __nv_bfloat16 bf16;

// A [B, H, S, D] bf16 view: element (b, h, s, d) at p[b*sb + h*sh + s*sr + d].
// Row starts are 16-byte aligned (the wrappers check it). The packed layout
// is one such view per q/k/v lane slice of qkv [B, S, 3*H*D]:
// (sb, sh, sr) = (S*3*H*D, D, 3*H*D), and o [B, S, H*D] is
// (S*H*D, D, H*D); a contiguous [B, H, S, D] tensor is (H*S*D, S*D, D).
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

// Accumulators a thread of an m64n16 product's lanes 64-79 at head dim D
// (one, unused, at 64).
template <int D>
__host__ __device__ constexpr int tail_regs() {
  return D == 80 ? 8 : 1;
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

// 2^x on the special-function unit, denormal results flushed to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace unite
