// K7: blocked matrix products for Hopper (sm_90a) on wgmma with TMA loads
// and stores, one persistent kernel body for two TPU kernels:
//
//   K7a replaces tools/quant_kernel_probe.py::_mm_kernel (called from
//       int8_matmul): out[m, n] = sum_k int32(x[m, k]) * int32(w[n, k]),
//       int8 operands, int32 accumulation, int32 out, no saturation.
//       Integer sums are exact, so the kernel equals its plain version bit
//       for bit while |sum| < 2^31 (K <= 131040 on the card). It is the
//       product of the int8 frozen teacher's four dense layers a block
//       (unite_torch/ops/quant.py::int8_dense).
//   K7b replaces tools/quant_kernel_probe.py::_mm_bf16_kernel (called from
//       bf16_matmul): bf16 operands, fp32 accumulation, the sum rounded once
//       to bf16 (cvt.rn.bf16x2.f32) at the end.
//
// Layout: x [M, K] and w [N, K], both row-major (the TPU kernels take w as
// [K, N]; [N, K] is the port's Linear layout, in which the quantized CLIP
// weights are stored), so both operands are K-major in shared memory, as
// the s8 wgmma requires: nothing is transposed. out [M, N] row-major. Any
// M and N; K * sizeof(T) a multiple of 32 bytes, rows 16-byte aligned (the
// wrappers check it). The two element types share the byte layout of
// their tiles: a ring stage holds 128 bytes of K a row (64 bf16 or 128
// int8, one 128-byte swizzle row), and a k-step of wgmma is 32 bytes deep
// in both (m64nNk16 bf16, m64nNk32 s8), so the body works in bytes; only
// the product instruction and the epilogue differ.
//
// Design:
// * persistent blocks, one an SM, walk the BM x BN output tiles with N
//   fastest within a band of M: the blocks in flight share a few bands of
//   x, read once from device memory, and w (at most 4.2 MB at the
//   teacher's shapes) stays in L2;
// * one producer thread keeps TMA loads of x's and w's [rows][128 B] boxes
//   (2-D maps, 128-byte swizzle) in a ring of stages with full and empty
//   mbarriers. Its stage and parity run on across tiles, so it loads tile
//   t+1 while the consumers finish tile t. TMA zero-fills rows past M or N
//   and bytes past K; zeros add exactly nothing in both types, so the main
//   loop needs no masks;
// * two consumer warpgroups (setmaxnreg 240) each own BM/2 rows of the
//   tile (one or two m64 products): per stage four k-steps of m64nBNk32
//   (s8) or m64nBNk16 (bf16) products from shared memory, one group kept
//   in flight, one fixed accumulator array a warpgroup (ptxas serializes
//   products whose accumulators move);
// * the epilogue streams: each warpgroup writes an m64 product's rows into
//   a staging tile in the output map's 128-byte swizzle (conflict-free)
//   and one thread stores it with TMA, which drops rows and columns past M
//   and N. The staging is waited for (its reads only) just before it is
//   written again, so tile t's output drains while tile t+1's products
//   run. A TMA store needs a row pitch that is a multiple of 16 bytes (N %
//   4 == 0 for int32, N % 8 == 0 for bf16); any other N takes a masked
//   direct store from the registers in the same body, chosen on the host.
//
// What bounds it on the H100: K7a at the int8 teacher's in_proj, out_proj
// and mlp_c_fc (M = 37824, K = 1024) moves mostly its int32 output (92-94%
// of the bytes) and is bound by bytes at 3.35 TB/s; mlp_c_proj (K = 4096)
// and the probe's bf16 38400x768x3072 are bound by operations (1,979 TOP/s
// int8, 989 TFLOP/s bf16). Hence the streaming store for the first, and
// wgmma (mma.sync reaches a fraction of the tensor cores' rate) for both.
// Measured (PERF.md, Findings): at in_proj the output alone streams at the
// rate of a fill, but the tiles' operand loads from L2 and the output
// share the memory system and overlap only partly; larger tiles (fewer
// L2 reads), direct stores and L2 eviction hints did not beat 128 x 128.
// The tile shape is a template parameter: the wrappers' default is the one
// measured fastest for each type (int8 128 x 128, bf16 256 x 128), the
// others stay for the sweep.
#include <string.h>

#include "fused_qkv_common.cuh"
#include "hopper.cuh"

using namespace unite;
using namespace hopper;

namespace {

constexpr int KBOX = 128;                 // bytes of K a ring stage
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer's
constexpr int SMEM_LIMIT = 232448;        // shared memory a block may take
constexpr int MAX_STAGES = 6;

template <typename T>
struct Elem;

template <>
struct Elem<int8_t> {  // K7a
  typedef int Acc;
  typedef int Out;
  static constexpr CUtensorMapDataType IN = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType OUT = CU_TENSOR_MAP_DATA_TYPE_INT32;
  static constexpr int BM = 128, BN = 128;  // the default tile
};

template <>
struct Elem<bf16> {  // K7b
  typedef float Acc;
  typedef bf16 Out;
  static constexpr CUtensorMapDataType IN = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType OUT = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int BM = 256, BN = 128;
};

// The shared-memory plan of a tile shape: a ring of STAGES stages (x's BM
// rows, then w's BN rows, 128 bytes each), then (TMA store) the staging of
// the output, 64 rows x BN a consumer warpgroup (one m64 product's rows: a
// warpgroup of 128 rows stages and stores them in two passes), then the
// full and empty barriers. As many stages as fit, up to MAX_STAGES.
template <typename T, int BM, int BN, bool TMA_STORE>
struct Plan {
  static constexpr int WM = BM / 2;   // rows of a consumer warpgroup
  static constexpr int MT = WM / 64;  // its m64 products a k-step
  static constexpr int A_BYTES = BM * KBOX;
  static constexpr int STAGE_BYTES = (BM + BN) * KBOX;
  static constexpr int OUT_BYTES = sizeof(typename Elem<T>::Out);
  static constexpr int BOX_COLS = KBOX / OUT_BYTES;  // a 128-byte store box
  static constexpr int PART = 64 * BN * OUT_BYTES;   // a warpgroup's staging
  static constexpr int STAGING = TMA_STORE ? 2 * PART : 0;
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - 16 * MAX_STAGES - STAGING) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + STAGING +
                              16 * STAGES;
  static_assert(MT * BN <= 256, "at most 128 accumulators a thread");
  static_assert(STAGES >= 2, "a ring of two stages at least");
};

// One k-step of a warpgroup's m64 product, 32 bytes deep.
__device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b,
                                    int accumulate) {
  wgmma_m64n128k32_s8_ss(d, a, b, accumulate);
}

__device__ __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b,
                                    int accumulate) {
  wgmma_m64n256k32_s8_ss(d, a, b, accumulate);
}

__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                    int accumulate) {
  wgmma_m64n128k16_ss(d, a, b, accumulate);
}

__device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b,
                                    int accumulate) {
  wgmma_m64n256k16_ss(d, a, b, accumulate);
}

template <typename Acc, int MT, int N>
__device__ __forceinline__ void fence_acc(Acc (&acc)[MT][N]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) reg_fence(acc[mt]);
}

// Rows r and r + 8 of one m64 product (accumulator element 4i + e: columns
// 8i + 2t + (e & 1), row r for e < 2, r + 8 above) into the staging tile:
// boxes of [64 rows][128 bytes], 16-byte chunk c of row r at c ^ (r & 7).
// int32: 8 columns are 32 bytes, so column block i lies in box i / 4,
// chunk 2(i % 4) + t / 2.
template <int N>
__device__ __forceinline__ void stage_rows(const int (&d)[N], uint8_t* st,
                                           int r, int t) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    uint8_t* box = st + (i / 4) * (64 * KBOX);
    const int chunk = ((2 * (i % 4) + (t >> 1)) ^ (r & 7)) << 4;
    const int lo = 8 * (t & 1);
    *reinterpret_cast<int2*>(box + r * KBOX + chunk + lo) =
        make_int2(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<int2*>(box + (r + 8) * KBOX + chunk + lo) =
        make_int2(d[4 * i + 2], d[4 * i + 3]);
  }
}

__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16: 8 columns are 16 bytes, so column block i lies in box i / 8,
// chunk i % 8.
template <int N>
__device__ __forceinline__ void stage_rows(const float (&d)[N], uint8_t* st,
                                           int r, int t) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    uint8_t* box = st + (i / 8) * (64 * KBOX);
    const int chunk = ((i % 8) ^ (r & 7)) << 4;
    *reinterpret_cast<uint32_t*>(box + r * KBOX + chunk + 4 * t) =
        round_pair(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(box + (r + 8) * KBOX + chunk + 4 * t) =
        round_pair(d[4 * i + 2], d[4 * i + 3]);
  }
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
    *reinterpret_cast<uint32_t*>(o + i) = round_pair(v0, v1);
  } else {
    o[i] = __float2bfloat16_rn(v0);
    if (two) o[i + 1] = __float2bfloat16_rn(v1);
  }
}

// The direct store of one m64 product's rows ra and ra + 8, columns from
// n0, masked to [M, N].
template <typename Acc, typename Out, int N>
__device__ __forceinline__ void store_rows(const Acc (&d)[N], Out* out,
                                           int M, int Ncols, int ra, int n0,
                                           int t) {
  const bool vec = (Ncols & 1) == 0;
  const int rb = ra + 8;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int col = n0 + 8 * i + 2 * t;
    if (col >= Ncols) break;
    const bool two = col + 1 < Ncols;
    if (ra < M)
      store_pair(out, (size_t)ra * Ncols + col, d[4 * i], d[4 * i + 1], two,
                 vec);
    if (rb < M)
      store_pair(out, (size_t)rb * Ncols + col, d[4 * i + 2], d[4 * i + 3],
                 two, vec);
  }
}

template <typename T, int BM, int BN, bool TMA_STORE>
__global__ void __launch_bounds__(THREADS, 1)
    blocked_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                                const __grid_constant__ CUtensorMap w_map,
                                const __grid_constant__ CUtensorMap out_map,
                                typename Elem<T>::Out* __restrict__ out,
                                int M, int N, int kblocks) {
  using P = Plan<T, BM, BN, TMA_STORE>;
  using Acc = typename Elem<T>::Acc;
  constexpr int S = P::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + S * P::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + P::STAGING);
  uint64_t* empty = full + S;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&x_map);
      tma_prefetch(&w_map);
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], P::STAGE_BYTES);
          uint8_t* st = ring + s * P::STAGE_BYTES;
          const int k = kb * (KBOX / (int)sizeof(T));
          tma_load_2d(st, &x_map, &full[s], k, m0);
          tma_load_2d(st + P::A_BYTES, &w_map, &full[s], k, n0);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x >> 7;  // rows [wg*WM, wg*WM + WM) of a tile
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const bool lead = (threadIdx.x & 127) == 0;
    uint8_t* stage_out = staging + wg * P::PART;
    Acc acc[P::MT][BN / 2];
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = Acc(0);
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      int held = 0;  // the stage whose products may still be in flight
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[s], phase);
        const uint8_t* st = ring + s * P::STAGE_BYTES;
        const uint64_t ad = desc_b128(st + wg * P::WM * KBOX, 16, 1024);
        const uint64_t bd = desc_b128(st + P::A_BYTES, 16, 1024);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KBOX / 32; ++kk)
#pragma unroll
          for (int mt = 0; mt < P::MT; ++mt)
            mma(acc[mt], ad + mt * ((64 * KBOX) >> 4) + 2 * kk, bd + 2 * kk,
                kb > 0 || kk > 0);
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the stage before this one has been read
        fence_acc(acc);
        if (kb > 0) mbar_arrive(&empty[held]);
        held = s;
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[held]);

      const int row = m0 + wg * P::WM;
      if constexpr (TMA_STORE) {
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt) {
          if (lead) bulk_wait<0, true>();  // the last store has read it
          named_sync(1 + wg, 128);
          stage_rows(acc[mt], stage_out, r0, t);
          fence_async_smem();
          named_sync(1 + wg, 128);
          if (lead) {
            const int rows = row + mt * 64;
            if (rows < M) {
#pragma unroll 1
              for (int j = 0; j < BN / P::BOX_COLS; ++j) {
                const int col = n0 + j * P::BOX_COLS;
                if (col < N)
                  tma_store_2d(&out_map, stage_out + j * 64 * KBOX, col,
                               rows);
              }
            }
            bulk_commit();
          }
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt)
          store_rows(acc[mt], out, M, N, row + mt * 64 + r0, n0, t);
      }
    }
    if (TMA_STORE && lead) bulk_wait<0, false>();  // out is written
  }
}

template <typename T, int BM, int BN, bool TMA_STORE>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           cudaStream_t stream) {
  using P = Plan<T, BM, BN, TMA_STORE>;
  using E = Elem<T>;
  const char* who = "unite_blocked_matmul_wgmma";
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const int box_k = KBOX / (int)sizeof(T);
  int err = encode_2d(&maps[0], E::IN, sizeof(T), x, K, M, box_k, BM, who);
  if (err == 0)
    err = encode_2d(&maps[1], E::IN, sizeof(T), w, K, N, box_k, BN, who);
  if (err == 0 && TMA_STORE)
    err = encode_2d(&maps[2], E::OUT, P::OUT_BYTES, out, N, M, P::BOX_COLS,
                    64, who);
  if (err != 0) return err;
  auto kernel = blocked_matmul_wgmma_kernel<T, BM, BN, TMA_STORE>;
  static bool sized = false;  // the kernel may take P::SMEM
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  const int kblocks = (int)(((long long)K * sizeof(T) + KBOX - 1) / KBOX);
  kernel<<<grid, THREADS, P::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<typename E::Out*>(out), M, N,
      kblocks);
  return (int)cudaGetLastError();
}

// bm x bn: 128 x 128, 128 x 256 or 256 x 128, or 0 x 0 for the type's
// default. An N whose output rows are not a multiple of 16 bytes takes the
// direct store at the default tile.
template <typename T>
int run(const void* x, const void* w, void* out, int M, int N, int K, int bm,
        int bn, void* stream) {
  typedef typename Elem<T>::Out Out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0)  // an empty sum
    return (int)cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(Out), st);
  constexpr int DM = Elem<T>::BM, DN = Elem<T>::BN;
  if (bm == 0 && bn == 0) {
    bm = DM;
    bn = DN;
  }
  if ((size_t)N * sizeof(Out) % 16 != 0)
    return launch<T, DM, DN, false>(x, w, out, M, N, K, st);
  if (bm == 128 && bn == 128)
    return launch<T, 128, 128, true>(x, w, out, M, N, K, st);
  if (bm == 128 && bn == 256)
    return launch<T, 128, 256, true>(x, w, out, M, N, K, st);
  if (bm == 256 && bn == 128)
    return launch<T, 256, 128, true>(x, w, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K7a: x [M, K] int8, w [N, K] int8 -> out [M, N] int32, K % 32 == 0, all
// row-major with 16-byte aligned rows. Launches on `stream`; returns a CUDA
// error code.
extern "C" int unite_int8_matmul(const void* x, const void* w, void* out,
                                 int M, int N, int K, void* stream) {
  return run<int8_t>(x, w, out, M, N, K, 0, 0, stream);
}

// K7b: x [M, K] bf16, w [N, K] bf16 -> out [M, N] bf16, K % 16 == 0.
extern "C" int unite_bf16_matmul(const void* x, const void* w, void* out,
                                 int M, int N, int K, void* stream) {
  return run<bf16>(x, w, out, M, N, K, 0, 0, stream);
}

// The same at a chosen tile shape bm x bn (for timing the shapes).
extern "C" int unite_int8_matmul_tile(const void* x, const void* w, void* out,
                                      int M, int N, int K, int bm, int bn,
                                      void* stream) {
  return run<int8_t>(x, w, out, M, N, K, bm, bn, stream);
}

extern "C" int unite_bf16_matmul_tile(const void* x, const void* w, void* out,
                                      int M, int N, int K, int bm, int bn,
                                      void* stream) {
  return run<bf16>(x, w, out, M, N, K, bm, bn, stream);
}
