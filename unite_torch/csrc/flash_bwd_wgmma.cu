// Flash attention backward for Hopper (sm_90a) over strided [B, H, S, D]
// bf16 views, any sequence length, as two kernels in the FlashAttention-2
// split the TPU has, on wgmma with TMA loads and a producer warp. One body
// of each serves two TPU kernels:
//
//   K4a replaces unite_tpu/ops/attention.py::_packed_dq_kernel,
//   K4b replaces unite_tpu/ops/attention.py::_packed_dkv_kernel
//   (both called from _packed_flash_bwd): q, k, v, o and do are lane slices
//   of the packed [B, S, 3*H*D] and [B, S, H*D] layouts, and dq, dk, dv are
//   written straight into the lane slices of the packed dqkv (the TPU's
//   concatenation does not survive), at D = 64 or 80;
//   K6 dq replaces unite_tpu/ops/attention.py::_bwd_dq_kernel,
//   K6 dkv replaces unite_tpu/ops/attention.py::_bwd_dkv_kernel
//   (both called from _flash_bwd): every tensor is a [B, H, S, D] view,
//   contiguous or strided, D = 64 or 80 (1569 = 1568 patches + CLS, 577,
//   785; 632 = the huge VideoMAE's encoder at mask 0.6).
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
// TPU kernels' own (:263 and :1004 against :289 and :1035) and is kept, and
// so is the split: dq, dk and dv are each one block's fp32 sum rounded
// once, with no atomics, so every gradient is deterministic. dkv runs
// after dq on one stream and reads the delta dq wrote.
//
// What bounds it on the H100: at [8, 1568, 2304], dq does 3 products
// (6*S^2*D flops a head, 9.1e10 in all, 0.092 ms at 989 TFLOP/s) and dkv 4
// (8*S^2*D, 0.122 ms), against 0.02-0.03 ms of bytes each: both are bound
// by operations, and only wgmma reaches the tensor cores' rate.
//
// Design. A block takes one (128-row tile, head, batch) with three
// warpgroups:
// * warpgroups 0 and 1 consume, 64 resident rows each (dq: queries, with
//   their q and do; dkv: keys, with their k and v), loaded once by TMA and
//   read once from shared memory into registers as wgmma A fragments, with
//   setmaxnreg raised. Per streamed 64-row tile, the two score products
//   (s = q.k^T and dp = do.v^T; s^T = k.q^T and dp^T = v.do^T) are wgmma
//   m64n64k16 with A from registers and the tile K-major in shared memory,
//   so the tensor cores read half the bytes of shared memory; p and ds are
//   formed on the fp32 accumulators in registers (a quad of lanes shares a
//   row: in dq lse2 and delta are per-thread scalars, in dkv they are per
//   column, read from the tile's copy in shared memory); rounded to bf16,
//   an m64n64 accumulator is already the A fragment of the next product,
//   which is wgmma m64n64k16 with A from registers and the same streamed
//   tile read MN-major (transpose bit): dq += ds.k, dv += p^T.do and
//   dk += ds^T.q;
// * warpgroup 2 produces, with setmaxnreg lowered: one thread starts TMA
//   loads of the resident rows (once) and of the streamed tiles (dq: k
//   and v; dkv: q and do, and the tiles' lse2 and delta through 1-D maps,
//   in boxes that start 16-byte aligned as TMA requires) into a ring of
//   128-byte-swizzled stages with full and empty mbarriers, so no block
//   barrier is taken after the set-up.
// A consumer starts tile j + 1's two score products (a commit group each),
// then tile j's gradient products; it forms tile j + 1's p as soon as s
// has retired and ds once dp has, while the gradient products run, and
// packs them once those have retired. Each accumulator belongs to one
// product and is read only after the wait that retires it.
// The tensor maps are 4-D (64 lanes, rows, heads, batch) from the views'
// element strides, so K4's lane slices and K6's views take one map type.
// Head dim 80 (the kernels are templated on D; D = 64 is the body above):
// lanes 64-79 of every tile come through a second map into tiles of 32-byte
// rows (32-byte swizzle); each score product takes a fifth k-step with A
// read from the resident rows' own 32-byte tile (they stay in shared
// memory), and each gradient product a second one, m64n16k16, into 8 more
// accumulators a thread. Shared memory grows by a quarter (128 KB).
// Ragged edges: rows past S in a box arrive as zeros; keys past S get p = 0
// in dq and queries past S get p^T = 0 and ds^T = 0 in dkv (their lse2
// and delta are another row's or zero, so nothing past S is trusted);
// resident rows past S are computed and never stored (1568 = 12*128 + 32,
// 1569 = 12*128 + 33, 577 = 4*128 + 65), and a consumer with no row before
// S stops at once. The tiles of a (batch, head) are neighbours in the
// grid, so the streamed operands come from L2 after the first tile.
#include "fused_qkv_common.cuh"
#include "attn_bwd_wgmma.cuh"
#include "hopper.cuh"

using namespace unite;
using namespace hopper;
using namespace attn_bwd;

namespace {

constexpr int BLOCK_ROWS = 128;            // resident rows: 64 a consumer
constexpr int BLOCK_T = 64;                // streamed rows a tile
constexpr int TILE_BYTES = 64 * 64 * 2;    // one 64-row bf16 tile: 8 KB
// A tile's lse2 or delta: a box of STAT_BOX values from the 16-byte
// aligned element at or before the tile's first (a box must start there),
// in a slot of STAT_SLOT values (a box's shared address is 128-byte aligned)
constexpr int STAT_BOX = BLOCK_T + 4;
constexpr int STAT_SLOT = 128;
constexpr int STAT_BYTES = STAT_SLOT * 4;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;             // threads of the two consumers
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
// lanes 64-79 of a 64-row tile at D = 80: 64 rows of 32 bytes
constexpr int TAIL_BYTES = 64 * 16 * 2;
constexpr int TILES = 4 + 2 * STAGES;

template <int D>
constexpr int smem_bytes() {
  return 1024 + (TILE_BYTES + (D == 80 ? TAIL_BYTES : 0)) * TILES +
         2 * STAT_BYTES * STAGES + 8 * (1 + 2 * STAGES);
}

constexpr uint64_t TILE_UNITS = TILE_BYTES >> 4;  // a tile in descriptor units
constexpr uint64_t TAIL_UNITS = TAIL_BYTES >> 4;

// The lanes-64-79 maps of q, k, v and do at D = 80 (none at 64).
template <int D>
struct TailMaps {
  CUtensorMap q, k, v, dout;
};
template <>
struct TailMaps<64> {};

struct Smem {
  bf16* res0;   // resident q (dq) or k (dkv): two 64-row tiles
  bf16* res1;   // resident do (dq) or v (dkv)
  bf16* str0;   // STAGES streamed k (dq) or q (dkv) tiles
  bf16* str1;   // STAGES streamed v (dq) or do (dkv) tiles
  bf16* res0t;  // D = 80: lanes 64-79 of each, laid out as they are
  bf16* res1t;
  bf16* str0t;
  bf16* str1t;
  float* lse;   // STAGES tiles of lse2 (dkv)
  float* delta; // STAGES tiles of delta (dkv)
  uint64_t* res_full;
  uint64_t* full;
  uint64_t* empty;
};

template <int D>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  uint8_t* p = raw + pad;
  Smem s;
  s.res0 = reinterpret_cast<bf16*>(p);
  s.res1 = reinterpret_cast<bf16*>(p + 2 * TILE_BYTES);
  s.str0 = reinterpret_cast<bf16*>(p + 4 * TILE_BYTES);
  s.str1 = reinterpret_cast<bf16*>(p + (4 + STAGES) * TILE_BYTES);
  p += TILES * TILE_BYTES;
  s.res0t = s.res1t = s.str0t = s.str1t = nullptr;
  if (D == 80) {
    s.res0t = reinterpret_cast<bf16*>(p);
    s.res1t = reinterpret_cast<bf16*>(p + 2 * TAIL_BYTES);
    s.str0t = reinterpret_cast<bf16*>(p + 4 * TAIL_BYTES);
    s.str1t = reinterpret_cast<bf16*>(p + (4 + STAGES) * TAIL_BYTES);
    p += TILES * TAIL_BYTES;
  }
  uint8_t* stats = p;
  s.lse = reinterpret_cast<float*>(stats);
  s.delta = reinterpret_cast<float*>(stats + STAT_BYTES * STAGES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 2 * STAT_BYTES * STAGES);
  s.res_full = bars;
  s.full = bars + 1;
  s.empty = s.full + STAGES;
  return s;
}

// pack_pairs for an accumulator whose values are already bf16 (dkv_p's p^T):
// the high halves of each pair, by byte permutation.
__device__ __forceinline__ void pack_rounded(const float (&s)[32],
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * kk + half;
      a[kk][2 * half] = __byte_perm(__float_as_uint(s[4 * i]),
                                    __float_as_uint(s[4 * i + 1]), 0x7632);
      a[kk][2 * half + 1] = __byte_perm(__float_as_uint(s[4 * i + 2]),
                                        __float_as_uint(s[4 * i + 3]), 0x7632);
    }
}

// dq side, in place, once s has retired: s <- p = exp2(s*c - lse2) in
// fp32 (rows g and g + 8 of the warp: lse2 ls0, ls1); keys at or past
// `valid` get p = 0.
template <bool MASK>
__device__ __forceinline__ void dq_p(float (&s)[32], int valid, int t,
                                     float c, float ls0, float ls1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = 8 * i + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !MASK || key + e < valid;
      s[4 * i + e] = ok ? fast_exp2(s[4 * i + e] * c - ls0) : 0.f;
      s[4 * i + 2 + e] = ok ? fast_exp2(s[4 * i + 2 + e] * c - ls1) : 0.f;
    }
  }
}

__device__ __forceinline__ void dq_tile_p(float (&s)[32], int j, int S, int t,
                                          float c, float ls0, float ls1) {
  const int valid = S - j * BLOCK_T;
  if (valid >= BLOCK_T)
    dq_p<false>(s, valid, t, c, ls0, ls1);
  else
    dq_p<true>(s, valid, t, c, ls0, ls1);
}

// Then, once dp has retired: s <- ds = p * (dp - delta) * scale (delta
// dl0, dl1 of rows g and g + 8).
__device__ __forceinline__ void dq_ds(float (&s)[32], const float (&dp)[32],
                                      float scale, float dl0, float dl1) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - dl0) * scale;
      s[4 * i + 2 + e] = s[4 * i + 2 + e] * (dp[4 * i + 2 + e] - dl1) * scale;
    }
}

// dkv side, in place, once s^T has retired: s <- p^T = bf16(exp2(s*c -
// lse2)) (as fp32, exactly), with lse2 of the tile's query columns 8i + 2t,
// +1 from shared memory; queries at or past `valid` get p^T = 0. A pair is
// rounded by one packed conversion: converting one value at a time runs at
// a fraction of the rate and held the kernel back.
template <bool MASK>
__device__ __forceinline__ void dkv_p(float (&s)[32], int valid, int t,
                                      float c, const float* ls) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
    const bool ok0 = !MASK || col < valid, ok1 = !MASK || col + 1 < valid;
    const float la0 = ls[col], la1 = ls[col + 1];
#pragma unroll
    for (int r = 0; r < 4; r += 2) {  // rows g and g + 8
      const int x = 4 * i + r;
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          ok0 ? fast_exp2(s[x] * c - la0) : 0.f,
          ok1 ? fast_exp2(s[x + 1] * c - la1) : 0.f);
      s[x] = __low2float(p);
      s[x + 1] = __high2float(p);
    }
  }
}

// Then, once dp^T has retired: dp <- ds^T = p^T * (dp^T - delta) * scale
// (0 past `valid`).
template <bool MASK>
__device__ __forceinline__ void dkv_ds(const float (&s)[32], float (&dp)[32],
                                       int valid, int t, float scale,
                                       const float* dl) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !MASK || col + e < valid;
      const float da = dl[col + e];
#pragma unroll
      for (int r = 0; r < 4; r += 2) {
        const int x = 4 * i + r + e;
        dp[x] = ok ? s[x] * (dp[x] - da) * scale : 0.f;
      }
    }
  }
}

// Tile j's statistics: its first one `first` (the index in the [B, H, S]
// array) sits (first & 3) values into its box.
__device__ __forceinline__ int stat_at(int j, int first) {
  return (j % STAGES) * STAT_SLOT + (first & 3);
}

__device__ __forceinline__ void dkv_tile_p(float (&s)[32], int j, int S, int t,
                                           float c, const Smem& sm,
                                           int first) {
  const int valid = S - j * BLOCK_T;
  const float* ls = sm.lse + stat_at(j, first);
  if (valid >= BLOCK_T)
    dkv_p<false>(s, valid, t, c, ls);
  else
    dkv_p<true>(s, valid, t, c, ls);
}

__device__ __forceinline__ void dkv_tile_ds(const float (&s)[32],
                                            float (&dp)[32], int j, int S,
                                            int t, float scale, const Smem& sm,
                                            int first) {
  const int valid = S - j * BLOCK_T;
  const float* dl = sm.delta + stat_at(j, first);
  if (valid >= BLOCK_T)
    dkv_ds<false>(s, dp, valid, t, scale, dl);
  else
    dkv_ds<true>(s, dp, valid, t, scale, dl);
}

// The streamed tiles of stage `st`.
__device__ __forceinline__ const bf16* str0_at(const Smem& sm, int st) {
  return sm.str0 + st * (TILE_BYTES / 2);
}

__device__ __forceinline__ const bf16* str1_at(const Smem& sm, int st) {
  return sm.str1 + st * (TILE_BYTES / 2);
}

// Tile n sits in stage n % STAGES, in phase (n / STAGES) & 1.
__device__ __forceinline__ void wait_full(const Smem& sm, int n) {
  mbar_wait(&sm.full[n % STAGES], (n / STAGES) & 1);
}

// Store a 64 x D fp32 accumulator (acc lanes 0-63, acc_t 64-79) as bf16
// rows `row` and `row + 8` (this thread's) of a view's head; rows at or
// past S are dropped.
template <int D, int NT>
__device__ __forceinline__ void store_acc(bf16* base, long long sr,
                                          const float (&acc)[32],
                                          const float (&acc_t)[NT], int row,
                                          int S, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (row < S)
      *reinterpret_cast<uint32_t*>(base + row * sr + col) =
          pack_f32(acc[4 * i], acc[4 * i + 1]);
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (row + 8) * sr + col) =
          pack_f32(acc[4 * i + 2], acc[4 * i + 3]);
  }
  if constexpr (D == 80) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 64 + 8 * i + 2 * t;
      if (row < S)
        *reinterpret_cast<uint32_t*>(base + row * sr + col) =
            pack_f32(acc_t[4 * i], acc_t[4 * i + 1]);
      if (row + 8 < S)
        *reinterpret_cast<uint32_t*>(base + (row + 8) * sr + col) =
            pack_f32(acc_t[4 * i + 2], acc_t[4 * i + 3]);
    }
  }
}

// rowsum(x * y) over the bf16 pairs of 32-bit words a and b.
__device__ __forceinline__ float word_dot(uint32_t a, uint32_t b) {
  const float2 fa =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return fa.x * fb.x + fa.y * fb.y;
}

// This lane's part of rowsum(x * y) over a D-lane bf16 row: lanes 16t..
// 16t + 15, and at D = 80 lanes 64 + 4t .. 64 + 4t + 3 (the quad sums the
// four parts).
template <int D>
__device__ __forceinline__ float row_dot(const bf16* x, const bf16* y, int t) {
  const uint4* xa = reinterpret_cast<const uint4*>(x + 16 * t);
  const uint4* ya = reinterpret_cast<const uint4*>(y + 16 * t);
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 a = xa[h], b = ya[h];
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) acc += word_dot(aw[w], bw[w]);
  }
  if constexpr (D == 80) {
    const uint2 a = *reinterpret_cast<const uint2*>(x + 64 + 4 * t);
    const uint2 b = *reinterpret_cast<const uint2*>(y + 64 + 4 * t);
    acc += word_dot(a.x, b.x);
    acc += word_dot(a.y, b.y);
  }
  return acc;
}

// The block's set-up: barriers (the empty ones count the live consumers'
// threads), then the roles split.
__device__ __forceinline__ void init_barriers(const Smem& sm, bool second_live) {
  if (threadIdx.x == 0) {
    mbar_init(sm.res_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], second_live ? CONSUMERS : CONSUMERS / 2);
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// The producer thread's resident loads: one 64-row box of each of two
// views a live consumer, at rows r0 and r0 + 64 (and at D = 80 their lanes
// 64-79 through t0, t1).
template <int D>
__device__ __forceinline__ void load_resident(
    const Smem& sm, const CUtensorMap* m0, const CUtensorMap* t0, int p0,
    const CUtensorMap* m1, const CUtensorMap* t1, int p1, int r0, int h,
    int b, bool second_live) {
  const int boxes = second_live ? 2 : 1;
  mbar_expect_tx(sm.res_full, 2 * boxes * (TILE_BYTES + (D == 80 ? TAIL_BYTES
                                                                  : 0)));
  for (int i = 0; i < boxes; ++i) {
    tma_load_view(sm.res0 + i * (TILE_BYTES / 2), m0, sm.res_full, p0,
                  r0 + i * BLOCK_T, h, b);
    tma_load_view(sm.res1 + i * (TILE_BYTES / 2), m1, sm.res_full, p1,
                  r0 + i * BLOCK_T, h, b);
    if constexpr (D == 80) {
      tma_load_view(sm.res0t + i * (TAIL_BYTES / 2), t0, sm.res_full, p0,
                    r0 + i * BLOCK_T, h, b);
      tma_load_view(sm.res1t + i * (TAIL_BYTES / 2), t1, sm.res_full, p1,
                    r0 + i * BLOCK_T, h, b);
    }
  }
}

// The producer thread's streamed loads of tile n (rows n*64..) into stage
// st: views m0, m1 (at D = 80 with their lanes 64-79 through t0, t1), and
// `extra` bytes more that the caller loads.
template <int D>
__device__ __forceinline__ void load_streamed(
    const Smem& sm, int st, const CUtensorMap* m0, const CUtensorMap* t0,
    int p0, const CUtensorMap* m1, const CUtensorMap* t1, int p1, int row,
    int h, int b, int extra) {
  mbar_expect_tx(&sm.full[st], 2 * (TILE_BYTES + (D == 80 ? TAIL_BYTES : 0)) +
                                   extra);
  tma_load_view(const_cast<bf16*>(str0_at(sm, st)), m0, &sm.full[st], p0,
                row, h, b);
  tma_load_view(const_cast<bf16*>(str1_at(sm, st)), m1, &sm.full[st], p1,
                row, h, b);
  if constexpr (D == 80) {
    tma_load_view(sm.str0t + st * (TAIL_BYTES / 2), t0, &sm.full[st], p0,
                  row, h, b);
    tma_load_view(sm.str1t + st * (TAIL_BYTES / 2), t1, &sm.full[st], p1,
                  row, h, b);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ TailMaps<D> tails, View o,
                          View dout, const float* __restrict__ lse,
                          float* __restrict__ delta, View dq, int S, int H,
                          float c, float scale, int perms) {
  constexpr int NT = tail_regs<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_ROWS;
  const int ntiles = (S + BLOCK_T - 1) / BLOCK_T;
  const int wg = threadIdx.x >> 7;
  const bool second_live = q0 + 64 < S;
  init_barriers(sm, second_live);

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      tma_prefetch(&do_map);
      const int pq = perms & 63, pk = (perms >> 6) & 63,
                pv = (perms >> 12) & 63, pdo = (perms >> 18) & 63;
      const CUtensorMap *qt = nullptr, *kt = nullptr, *vt = nullptr,
                        *dot = nullptr;
      if constexpr (D == 80) {
        qt = &tails.q;
        kt = &tails.k;
        vt = &tails.v;
        dot = &tails.dout;
      }
      load_resident<D>(sm, &q_map, qt, pq, &do_map, dot, pdo, q0, h, b,
                       second_live);
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % STAGES;
        mbar_wait(&sm.empty[st], ((n / STAGES) & 1) ^ 1);
        load_streamed<D>(sm, st, &k_map, kt, pk, &v_map, vt, pv,
                         n * BLOCK_T, h, b, 0);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    if (wg == 1 && !second_live) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
    const size_t stat = ((size_t)b * H + h) * S;

    // delta = rowsum(do * o) for rows `row` and `row + 8`, written out for
    // the dK/dV kernel, while the resident tiles arrive
    const bf16* do_h = dout.head(b, h);
    const bf16* o_h = o.head(b, h);
    float dl0 = row < S ? row_dot<D>(do_h + row * dout.sr,
                                     o_h + row * o.sr, t)
                        : 0.f;
    float dl1 = row + 8 < S ? row_dot<D>(do_h + (row + 8) * dout.sr,
                                         o_h + (row + 8) * o.sr, t)
                            : 0.f;
    dl0 = quad_sum(dl0);
    dl1 = quad_sum(dl1);
    if (t == 0) {
      if (row < S) delta[stat + row] = dl0;
      if (row + 8 < S) delta[stat + row + 8] = dl1;
    }
    const float ls0 = row < S ? lse[stat + row] : 0.f;
    const float ls1 = row + 8 < S ? lse[stat + row + 8] : 0.f;

    const int w = (threadIdx.x >> 5) & 3;
    const uint64_t kd = kmajor(sm.str0), vd = kmajor(sm.str1);
    const uint64_t kt = mnmajor(sm.str0);
    // D = 80: lanes 64-79 of the streamed k (K-major and MN-major) and v,
    // and of the resident q and do, read by the products from their tiles
    uint64_t ktd = 0, vtd = 0, ktt = 0, qtd = 0, dotd = 0;
    if constexpr (D == 80) {
      ktd = kmajor_t(sm.str0t);
      vtd = kmajor_t(sm.str1t);
      ktt = mnmajor_t(sm.str0t);
      qtd = kmajor_t(sm.res0t + wg * 64 * 16);
      dotd = kmajor_t(sm.res1t + wg * 64 * 16);
    }
    float acc[32], acc_t[NT], s[32], dp[32];
    uint32_t qa[4][4], doa[4][4], ds[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) acc_t[i] = 0.f;
    mbar_wait(sm.res_full, 0);
    load_frags(qa, sm.res0 + wg * 64 * 64, w, g, t);
    load_frags(doa, sm.res1 + wg * 64 * 64, w, g, t);

    wait_full(sm, 0);
    scores_start<D>(s, dp, qa, kd, qtd, ktd, doa, vd, dotd, vtd);
    wgmma_wait<1>();
    reg_fence(s);
    dq_tile_p(s, 0, S, t, c, ls0, ls1);
    wgmma_wait<0>();
    reg_fence(dp);
    dq_ds(s, dp, scale, dl0, dl1);
    pack_pairs(s, ds);
    for (int j = 0; j + 1 < ntiles; ++j) {
      const int n1 = (j + 1) % STAGES;
      wait_full(sm, j + 1);
      const int n0 = j % STAGES;
      scores_start<D>(s, dp, qa, kd + n1 * TILE_UNITS, qtd,
                      ktd + n1 * TAIL_UNITS, doa, vd + n1 * TILE_UNITS, dotd,
                      vtd + n1 * TAIL_UNITS);
      grad_start<D>(acc, acc_t, ds, kt + n0 * TILE_UNITS,
                    ktt + n0 * TAIL_UNITS);
      wgmma_wait<2>();  // products retire in order: s is done
      reg_fence(s);
      dq_tile_p(s, j + 1, S, t, c, ls0, ls1);
      wgmma_wait<1>();  // dp is done
      reg_fence(dp);
      dq_ds(s, dp, scale, dl0, dl1);
      wgmma_wait<0>();
      acc_fence<D>(acc, acc_t);
      mbar_arrive(&sm.empty[n0]);
      pack_pairs(s, ds);
    }
    {
      const int n0 = (ntiles - 1) % STAGES;
      grad_start<D>(acc, acc_t, ds, kt + n0 * TILE_UNITS,
                    ktt + n0 * TAIL_UNITS);
      wgmma_wait<0>();
      acc_fence<D>(acc, acc_t);
      mbar_arrive(&sm.empty[n0]);
    }
    store_acc<D>(dq.head(b, h), dq.sr, acc, acc_t, row, S, t);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap lse_map,
                           const __grid_constant__ CUtensorMap delta_map,
                           const __grid_constant__ TailMaps<D> tails,
                           View dk, View dv, int S, int H, float c,
                           float scale, int perms) {
  constexpr int NT = tail_regs<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BLOCK_ROWS;
  const int ntiles = (S + BLOCK_T - 1) / BLOCK_T;
  const int wg = threadIdx.x >> 7;
  const bool second_live = k0 + 64 < S;
  init_barriers(sm, second_live);

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      tma_prefetch(&do_map);
      tma_prefetch(&lse_map);
      tma_prefetch(&delta_map);
      const int pq = perms & 63, pk = (perms >> 6) & 63,
                pv = (perms >> 12) & 63, pdo = (perms >> 18) & 63;
      const int stat = (b * H + h) * S;  // the head's first statistic
      const CUtensorMap *qt = nullptr, *kt = nullptr, *vt = nullptr,
                        *dot = nullptr;
      if constexpr (D == 80) {
        qt = &tails.q;
        kt = &tails.k;
        vt = &tails.v;
        dot = &tails.dout;
      }
      load_resident<D>(sm, &k_map, kt, pk, &v_map, vt, pv, k0, h, b,
                       second_live);
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % STAGES;
        mbar_wait(&sm.empty[st], ((n / STAGES) & 1) ^ 1);
        load_streamed<D>(sm, st, &q_map, qt, pq, &do_map, dot, pdo,
                         n * BLOCK_T, h, b, 2 * STAT_BOX * 4);
        const int box = (stat + n * BLOCK_T) & ~3;
        tma_load_1d(sm.lse + st * STAT_SLOT, &lse_map, &sm.full[st], box);
        tma_load_1d(sm.delta + st * STAT_SLOT, &delta_map, &sm.full[st], box);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    if (wg == 1 && !second_live) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row = k0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
    const int stat = (b * H + h) * S;  // the head's first statistic

    const int w = (threadIdx.x >> 5) & 3;
    const uint64_t qd = kmajor(sm.str0), dod = kmajor(sm.str1);
    const uint64_t qt = mnmajor(sm.str0), dot = mnmajor(sm.str1);
    // D = 80: lanes 64-79 of the streamed q and do (K-major and MN-major)
    // and of the resident k and v
    uint64_t qtd = 0, dotd = 0, qtt = 0, dott = 0, ktd = 0, vtd = 0;
    if constexpr (D == 80) {
      qtd = kmajor_t(sm.str0t);
      dotd = kmajor_t(sm.str1t);
      qtt = mnmajor_t(sm.str0t);
      dott = mnmajor_t(sm.str1t);
      ktd = kmajor_t(sm.res0t + wg * 64 * 16);
      vtd = kmajor_t(sm.res1t + wg * 64 * 16);
    }
    float dk_acc[32], dv_acc[32], dk_t[NT], dv_t[NT], s[32], dp[32];
    uint32_t ka[4][4], va[4][4], pa[4][4], dsa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) dk_t[i] = dv_t[i] = 0.f;
    mbar_wait(sm.res_full, 0);
    load_frags(ka, sm.res0 + wg * 64 * 64, w, g, t);
    load_frags(va, sm.res1 + wg * 64 * 64, w, g, t);

    wait_full(sm, 0);
    scores_start<D>(s, dp, ka, qd, ktd, qtd, va, dod, vtd, dotd);
    wgmma_wait<1>();
    reg_fence(s);
    dkv_tile_p(s, 0, S, t, c, sm, stat);
    wgmma_wait<0>();
    reg_fence(dp);
    dkv_tile_ds(s, dp, 0, S, t, scale, sm, stat);
    pack_rounded(s, pa);
    pack_pairs(dp, dsa);
    for (int j = 0; j + 1 < ntiles; ++j) {
      const int n0 = j % STAGES, n1 = (j + 1) % STAGES;
      wait_full(sm, j + 1);
      scores_start<D>(s, dp, ka, qd + n1 * TILE_UNITS, ktd,
                      qtd + n1 * TAIL_UNITS, va, dod + n1 * TILE_UNITS, vtd,
                      dotd + n1 * TAIL_UNITS);
      grads_start<D>(dv_acc, dv_t, pa, dot + n0 * TILE_UNITS,
                     dott + n0 * TAIL_UNITS, dk_acc, dk_t, dsa,
                     qt + n0 * TILE_UNITS, qtt + n0 * TAIL_UNITS);
      const int first = stat + (j + 1) * BLOCK_T;
      wgmma_wait<2>();  // products retire in order: s^T is done
      reg_fence(s);
      dkv_tile_p(s, j + 1, S, t, c, sm, first);
      wgmma_wait<1>();  // dp^T is done
      reg_fence(dp);
      dkv_tile_ds(s, dp, j + 1, S, t, scale, sm, first);
      wgmma_wait<0>();
      acc_fence<D>(dv_acc, dv_t);
      acc_fence<D>(dk_acc, dk_t);
      mbar_arrive(&sm.empty[n0]);
      pack_rounded(s, pa);
      pack_pairs(dp, dsa);
    }
    {
      const int n0 = (ntiles - 1) % STAGES;
      grads_start<D>(dv_acc, dv_t, pa, dot + n0 * TILE_UNITS,
                     dott + n0 * TAIL_UNITS, dk_acc, dk_t, dsa,
                     qt + n0 * TILE_UNITS, qtt + n0 * TAIL_UNITS);
      wgmma_wait<0>();
      acc_fence<D>(dv_acc, dv_t);
      acc_fence<D>(dk_acc, dk_t);
      mbar_arrive(&sm.empty[n0]);
    }
    store_acc<D>(dk.head(b, h), dk.sr, dk_acc, dk_t, row, S, t);
    store_acc<D>(dv.head(b, h), dv.sr, dv_acc, dv_t, row, S, t);
  }
}

// The 4-D maps of views `which` (indices into the entry's views) in
// 64-row boxes, and at D = 80 their lanes-64-79 maps (q, k, v, do);
// perms packs each map's row/head/batch permutation, 6 bits a map, in that
// order.
template <int D>
int encode_views(CUtensorMap (&maps)[4], TailMaps<D>& tails, int* perms,
                 const void* const* ptrs, const int (&which)[4],
                 const long long* strides, int B, int H, int S,
                 const char* who) {
  CUtensorMap tmaps[4];
  *perms = 0;
  for (int i = 0; i < 4; ++i) {
    int perm = 0;
    const int err = encode_view_d(&maps[i], &tmaps[i], D, ptrs[i],
                                  strides + 3 * which[i], B, H, S, BLOCK_T,
                                  &perm, who);
    if (err != 0) return err;
    *perms |= perm << (6 * i);
  }
  if constexpr (D == 80) {
    tails.q = tmaps[0];
    tails.k = tmaps[1];
    tails.v = tmaps[2];
    tails.dout = tmaps[3];
  }
  return 0;
}

template <int D, typename K>
int prepare(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
}

template <int D>
int run_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           const long long* strides, int B, int S, int H, float c,
           float scale, void* stream) {
  CUtensorMap maps[4];
  TailMaps<D> tails;
  int perms = 0;
  const void* ptrs[4] = {q, k, v, dout};
  int err = encode_views<D>(maps, tails, &perms, ptrs, {0, 1, 2, 4}, strides,
                            B, H, S, "unite_flash_dq");
  if (err == 0) err = prepare<D>(flash_dq_wgmma_kernel<D>);
  if (err != 0) return err;
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  flash_dq_wgmma_kernel<D><<<grid, THREADS, smem_bytes<D>(),
                             (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], tails, view_of(o, strides, 3),
      view_of(dout, strides, 4), static_cast<const float*>(lse),
      static_cast<float*>(delta), view_of(dq, strides, 5), S, H, c, scale,
      perms);
  return (int)cudaGetLastError();
}

template <int D>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const long long* strides, int B, int S, int H, float c,
            float scale, void* stream) {
  CUtensorMap maps[4], stats[2];
  TailMaps<D> tails;
  int perms = 0;
  const void* ptrs[4] = {q, k, v, dout};
  const long long n = (long long)B * H * S;
  int err = encode_views<D>(maps, tails, &perms, ptrs, {0, 1, 2, 3}, strides,
                            B, H, S, "unite_flash_dkv");
  if (err == 0) err = encode_1d_f32(&stats[0], lse, n, STAT_BOX,
                                    "unite_flash_dkv");
  if (err == 0) err = encode_1d_f32(&stats[1], delta, n, STAT_BOX,
                                    "unite_flash_dkv");
  if (err == 0) err = prepare<D>(flash_dkv_wgmma_kernel<D>);
  if (err != 0) return err;
  const dim3 grid((S + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  flash_dkv_wgmma_kernel<D><<<grid, THREADS, smem_bytes<D>(),
                              (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], stats[0], stats[1], tails,
      view_of(dk, strides, 4), view_of(dv, strides, 5), S, H, c, scale,
      perms);
  return (int)cudaGetLastError();
}

}  // namespace

// dq and delta. q, k, v, o, do and dq are [B, H, S, D] bf16 views whose
// (batch, head, row) strides in elements are strides[3i..3i+2] in that
// order; lse (in) and delta (out) [B, H, S] fp32 contiguous. D = 64 or 80
// (cudaErrorInvalidValue for any other). c = scale*log2(e). q, k, v and do
// need 16-byte aligned bases and strides that are multiples of 8 elements
// (for a dimension of extent > 1). Launches on `stream`; returns a CUDA
// error code (that of the launch, or of a tensor map that could not be
// made).
extern "C" int unite_flash_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              const long long* strides, int B, int S, int H,
                              int D, float c, float scale, void* stream) {
  if (D == 64)
    return run_dq<64>(q, k, v, o, dout, lse, delta, dq, strides, B, S, H, c,
                      scale, stream);
  if (D == 80)
    return run_dq<80>(q, k, v, o, dout, lse, delta, dq, strides, B, S, H, c,
                      scale, stream);
  return (int)cudaErrorInvalidValue;
}

// dk and dv from q, k, v, do, lse and the dq kernel's delta. Views q, k, v,
// do, dk, dv with strides[3i..3i+2] in that order, the same rules as
// unite_flash_dq's.
extern "C" int unite_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv,
                               const long long* strides, int B, int S, int H,
                               int D, float c, float scale, void* stream) {
  if (D == 64)
    return run_dkv<64>(q, k, v, dout, lse, delta, dk, dv, strides, B, S, H,
                       c, scale, stream);
  if (D == 80)
    return run_dkv<80>(q, k, v, dout, lse, delta, dk, dv, strides, B, S, H,
                       c, scale, stream);
  return (int)cudaErrorInvalidValue;
}
