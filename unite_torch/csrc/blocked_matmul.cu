// K7: blocked matrix products for Hopper (sm_90a), one kernel body for two
// TPU kernels:
//
//   K7a replaces tools/quant_kernel_probe.py::_mm_kernel (called from
//       int8_matmul): out[m, n] = sum_k int32(x[m, k]) * int32(w[n, k]),
//       int8 operands, int32 accumulation, int32 out. Integer sums are
//       exact, so the kernel equals its plain version bit for bit. It is
//       the product of the int8 frozen teacher's four dense layers a block
//       (unite_torch/ops/quant.py::int8_dense).
//   K7b replaces tools/quant_kernel_probe.py::_mm_bf16_kernel (called from
//       bf16_matmul): bf16 operands, fp32 accumulation, one rounding of the
//       sum to bf16 at the end.
//
// Layout: x [M, K] and w [N, K], both row-major, so both operands are
// K-contiguous as mma.sync's row.col form wants them (the TPU kernels take
// w as [K, N]; [N, K] is the port's Linear layout, in which the quantized
// CLIP weights are stored). out [M, N] row-major. Any M and N: the ragged
// edge tiles load zeros and store nothing outside [M, N]. K * sizeof(T)
// must be a multiple of 32 bytes (K % 32 == 0 for int8, K % 16 == 0 for
// bf16), so every 32-byte step of K is either whole or entirely past the
// end; the wrappers check it.
//
// The two element types share the byte layout of their fragments: a 16x32
// int8 tile (mma m16n8k32.s8) and a 16x16 bf16 tile (m16n8k16.bf16) are
// both 16 rows of 32 bytes, a lane holding bytes 4t..4t+3 and 16+4t..16+4t+3
// of rows g and g+8 (PTX ISA, lane = 4g + t), and the 32x8 / 16x8 right
// operands likewise. So one ldmatrix.x4 on 16-byte rows loads either, and
// the kernel body works in bytes; only the mma instruction and the epilogue
// differ.
//
// Design: one block of 8 warps per 128x128 tile of out; warps in a 2x4
// grid, each 64x32 (4x4 mma tiles, 64 accumulators a thread). K streams
// through shared memory in 64-byte steps, three stages deep with cp.async,
// rows padded to 80 bytes so the eight rows of each ldmatrix fall in eight
// distinct bank groups. Blocks of one row of tiles are neighbours in the
// grid, so x's rows come from L2 after the first block reads them; w (2.4
// to 4.2 MB at the teacher's shapes) stays in L2.
//
// What bounds it on the H100: at the probe's 38400x768x3072 K7a does 1.8e11
// integer operations (0.092 ms at 1979 TOP/s) and moves 504 MB, 472 MB of
// it the int32 output (0.150 ms at 3.35 TB/s): it is bound by bytes, and
// the int32 output is the cost; its best is about 1.2x a bf16 product, not
// 2x. The teacher's layers at M = 37824 are bound by bytes too, except
// mlp_c_proj (K = 4096), bound by operations. K7b at the probe shape is
// bound by operations (0.183 ms at 989 TFLOP/s against 300 MB). The output
// is written straight from the accumulators, 8 bytes a lane, 32 contiguous
// bytes a quad: whole 32-byte sectors. mma.sync reaches a fraction of the
// tensor cores' rate, which wgmma with TMA loads (a later PR) would lift; a
// dequantising epilogue that writes bf16 would cut the output bytes by half
// but is a different function.
#include "fused_qkv_common.cuh"

using namespace unite;

namespace {

constexpr int BM = 128, BN = 128;  // output tile of a block
constexpr int BKB = 64;            // bytes of K a stage
constexpr int PITCH_B = BKB + 16;  // shared-memory row pitch in bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * PITCH_B;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 61,440

__device__ __forceinline__ void mma_tile(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(c, a, b0, b1);
}

__device__ __forceinline__ void mma_tile(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring outputs (row-major index i, i + 1); `two` when i + 1 is
// inside the row, `vec` when a pair store is aligned (N even).
__device__ __forceinline__ void store_pair(int* o, size_t i, int v0, int v1,
                                           bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<int2*>(o + i) = make_int2(v0, v1);
  } else {
    o[i] = v0;
    if (two) o[i + 1] = v1;
  }
}

__device__ __forceinline__ void store_pair(bf16* o, size_t i, float v0,
                                           float v1, bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<uint32_t*>(o + i) = pack_f32(v0, v1);
  } else {
    o[i] = __float2bfloat16_rn(v0);
    if (two) o[i + 1] = __float2bfloat16_rn(v1);
  }
}

// Rows [row0, row0 + 128) x bytes [kb, kb + 64) of a row-major operand with
// `ld` bytes a row into shared memory at pitch PITCH_B; rows at or past
// `rows` and bytes at or past `ld` read as zeros. Two 16-byte copies a
// thread.
__device__ __forceinline__ void load_stage(unsigned char* dst,
                                           const unsigned char* src, int ld,
                                           int row0, int rows, int kb) {
#pragma unroll
  for (int idx = threadIdx.x; idx < BM * (BKB / 16); idx += THREADS) {
    const int r = idx >> 2, col = (idx & 3) * 16;
    const bool ok = row0 + r < rows && kb + col < ld;
    const unsigned char* p =
        ok ? src + (size_t)(row0 + r) * ld + kb + col : src;
    cp_async16(dst + r * PITCH_B + col, p, ok);
  }
}

template <typename Acc, typename Out>
__global__ void __launch_bounds__(THREADS, 2)
    blocked_matmul_kernel(const unsigned char* __restrict__ x,
                          const unsigned char* __restrict__ w,
                          Out* __restrict__ out, int M, int N, int kbytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  const int ktiles = (kbytes + BKB - 1) / BKB;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      unsigned char* st = smem + s * STAGE_BYTES;
      load_stage(st, x, kbytes, m0, M, s * BKB);
      load_stage(st + BM * PITCH_B, w, kbytes, n0, N, s * BKB);
    }
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane. A (16 rows x 32 bytes): matrices
  // (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) in fragment order a0..a3. B
  // (8 n-rows x 32 bytes, two n-tiles): (n-tile j, bytes 0-15), (j, 16-31),
  // (j + 1, 0-15), (j + 1, 16-31) -> b[j][0], b[j][1], b[j+1][0], b[j+1][1].
  const int a_off = (wm + (lane & 15)) * PITCH_B + (lane >> 4) * 16;
  const int b_off =
      (wn + (lane & 7) + (lane >> 4) * 8) * PITCH_B + ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      unsigned char* st = smem + (next % STAGES) * STAGE_BYTES;
      load_stage(st, x, kbytes, m0, M, next * BKB);
      load_stage(st + BM * PITCH_B, w, kbytes, n0, N, next * BKB);
    }
    cp_async_commit();

    const unsigned char* as = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* bs = as + BM * PITCH_B;
#pragma unroll
    for (int kk = 0; kk < BKB; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], reinterpret_cast<const bf16*>(as + a_off +
                                                    i * 16 * PITCH_B + kk));
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, reinterpret_cast<const bf16*>(bs + b_off +
                                                 j * 8 * PITCH_B + kk));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tile(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // C fragment: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8
  const int g = lane >> 2, t = lane & 3;
  const bool vec = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ra = m0 + wm + i * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      if (ra < M)
        store_pair(out, (size_t)ra * N + col, acc[i][j][0], acc[i][j][1], two,
                   vec);
      if (rb < M)
        store_pair(out, (size_t)rb * N + col, acc[i][j][2], acc[i][j][3], two,
                   vec);
    }
  }
}

template <typename Acc, typename Out>
int launch(const void* x, const void* w, void* out, int M, int N, int kbytes,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blocked_matmul_kernel<Acc, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  blocked_matmul_kernel<Acc, Out><<<grid, THREADS, SMEM_BYTES,
                                    (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(x),
      static_cast<const unsigned char*>(w), static_cast<Out*>(out), M, N,
      kbytes);
  return (int)cudaGetLastError();
}

}  // namespace

// K7a: x [M, K] int8, w [N, K] int8 -> out [M, N] int32, K % 32 == 0, all
// row-major with 16-byte aligned rows. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int unite_int8_matmul(const void* x, const void* w, void* out,
                                 int M, int N, int K, void* stream) {
  return launch<int, int>(x, w, out, M, N, K, stream);
}

// K7b: x [M, K] bf16, w [N, K] bf16 -> out [M, N] bf16, K % 16 == 0.
extern "C" int unite_bf16_matmul(const void* x, const void* w, void* out,
                                 int M, int N, int K, void* stream) {
  return launch<float, bf16>(x, w, out, M, N, 2 * K, stream);
}
