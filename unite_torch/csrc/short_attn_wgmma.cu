// Short-sequence attention forward for Hopper (sm_90a): one head's whole K
// and V resident in shared memory, on wgmma with TMA loads, a producer
// warp and persistent blocks. One kernel body serves two TPU kernels:
//
//   K1 replaces unite_tpu/ops/attention.py::_fused_qkv_kernel (called from
//      _fused_qkv_fwd): q, k, v are lane slices of the packed qkv
//      [B, S, 3*H*64] and o is written into [B, S, H*64]; l is the row sum
//      of the ROUNDED p, and the base-2 row log-sum-exp lse2 = m*c + log2(l)
//      is saved, [B, H, S] fp32, when the caller trains (K2 reads it);
//   K5 replaces unite_tpu/ops/attention.py::_grouped_fwd_kernel (called
//      from _grouped_attention_fwd): q, k, v and o are [B, H, S, 64] views;
//      l is the row sum of the fp32 e = exp2((s - m)*c) BEFORE rounding, and
//      the raw row max m and l are saved, [B, H, S] fp32 each, when the
//      caller trains (csrc/grouped_attn_bwd.cu reads them).
//
// Both: bf16 operands, fp32 accumulation, c = scale*log2(e) folded into
// exp2, p = exp2((s - m)*c) rounded to bf16 against the EXACT row max m over
// all S keys, o = (p.v) * (1/l) in bf16. An online-softmax rescale would
// round p against a running max, a different function, so the exact max
// comes first: from registers where a 64-query tile's whole score row fits
// (S <= 320, one q.k^T sweep), else from a first sweep over the resident K
// (S > 320: two sweeps, tensor-core time only, no extra bytes).
//
// What bounds it on the H100: at the main-path shapes (197 and 320 keys, 12
// or 16 heads; 392 keys for K5) a head does 4*S^2*64 flops on 4*S*64*2
// bytes, about S/2 flops a byte (100-200), under the card's ridge of about
// 295: the bound is the bytes of q, k and v read and o written. So each
// head's K and V are read once, and the loads run under the products of
// the item before:
// * a block is persistent (one an SM) and walks (batch, head) items; one
//   producer thread starts TMA loads of the item's whole K and V (boxes of
//   64 rows, 128-byte swizzle, rows past S zero-filled) into one of two
//   buffers (one above 320 keys: 768 keys take 192 KB), then of its 64-row
//   q tiles into a ring of four (two above 320 keys), so the next item's K
//   and V arrive while the consumers finish this one;
// * two consumer warpgroups take the block's q tiles in turn (tile t to
//   warpgroup t % 2, across items, so 197 = 3*64 + 5 and 320 = 5*64 keep
//   both busy): q.k^T is wgmma with q and k K-major in shared memory, as
//   wide as the chunks allow (m64n256k16 for 256 keys, beside m64n64k16 at
//   320, m64n128k16 up to 128) so q is read from shared memory once a
//   k-step; the row max and exp2 run on the fp32 accumulators in registers
//   (a quad of lanes shares a row); the rounded p, packed in place, is the
//   A operand of p.v, wgmma m64n64k16 with A from registers and v MN-major
//   (the transpose bit);
// * one sweep holds NC 64-key chunks (NC*32 fp32 registers a thread: 128
//   at 197 keys, 160 at 320); above 320 keys, groups of 256 keys are swept
//   twice.
// With the loads hidden, a consumer's tile is a chain of dependent phases
// (products, row max, exp2, products, store) that two warps an SM
// sub-partition cannot overlap much, so the design cuts instructions and
// dependency chains there: the row max and K5's fp32 sums run in four
// partial chains a row, exp2's argument is one fma (s*c - m*c), padding
// keys in 16-key steps take no exp2, K1's l (the sum of the rounded p)
// comes from the tensor cores as p times a block of bf16 ones (m64n8k16,
// every column the row sum), and o is written in bf16 into a staging tile
// in the map's swizzle and stored by TMA, which drops rows past S.
// Masking: keys at or past S are left out of the max and get p = 0 (their
// zero-filled rows would give s = 0, which would raise the max of a row
// whose real scores are all negative); query rows past S are computed on
// zeros and never stored. Every chunk a sweep takes is loaded, so every
// key row a product reads is a real row or a TMA zero.
#include "fused_qkv_common.cuh"
#include "hopper.cuh"

using namespace unite;
using namespace hopper;

namespace {

constexpr int TILE_Q = 64;                 // queries a consumer tile
constexpr int CHUNK = 64;                  // keys a q.k^T accumulator
constexpr int GROUP = 4 * CHUNK;           // keys a group when swept twice
constexpr int ROW_BYTES = 64 * 2;          // one row of 64 bf16 lanes
constexpr int BOX_BYTES = 64 * ROW_BYTES;  // a 64-row TMA box: 8 KB
constexpr int CONSUMERS = 256;             // threads of the two consumers
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
constexpr uint64_t CHUNK_UNITS = (CHUNK * ROW_BYTES) >> 4;  // descriptor units
constexpr int MAX_SEQ = 768;

// The shared-memory plan of a launch: MULTI sweeps groups of 256 keys
// twice; `rows` key rows are loaded (a multiple of the keys a sweep takes,
// so every row a product reads is loaded) into KV_STAGES buffers; q tiles
// come through a ring of Q_STAGES; 1 KB of bf16 ones is the B operand of
// the row sums; each consumer stages its o tile in 8 KB of its own. 768
// keys take 231,472 bytes of the 232,448 a block may have.
template <bool MULTI>
struct Layout {
  static constexpr int KV_STAGES = MULTI ? 1 : 2;
  static constexpr int Q_STAGES = MULTI ? 2 : 4;
  static __host__ __device__ int bytes(int rows) {
    return 1024 + 1024 + KV_STAGES * 2 * rows * ROW_BYTES +
           (Q_STAGES + 2) * BOX_BYTES + 8 * 2 * (Q_STAGES + KV_STAGES);
  }
};

struct Smem {
  bf16* ones;  // 512 bf16 ones
  bf16* k;     // KV_STAGES buffers of `rows` rows
  bf16* v;
  bf16* q;     // Q_STAGES tiles
  bf16* o;     // two staging tiles, one a consumer
  uint64_t* q_full;
  uint64_t* q_empty;
  uint64_t* kv_full;
  uint64_t* kv_empty;
  int rows;
  __device__ __forceinline__ bf16* k_at(int st) const {
    return k + (size_t)st * rows * 64;
  }
  __device__ __forceinline__ bf16* v_at(int st) const {
    return v + (size_t)st * rows * 64;
  }
};

template <bool MULTI>
__device__ __forceinline__ Smem carve(uint8_t* raw, int rows) {
  using L = Layout<MULTI>;
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  uint8_t* p = raw + pad;
  Smem s;
  s.rows = rows;
  s.ones = reinterpret_cast<bf16*>(p);
  p += 1024;
  s.k = reinterpret_cast<bf16*>(p);
  p += L::KV_STAGES * rows * ROW_BYTES;
  s.v = reinterpret_cast<bf16*>(p);
  p += L::KV_STAGES * rows * ROW_BYTES;
  s.q = reinterpret_cast<bf16*>(p);
  p += L::Q_STAGES * BOX_BYTES;
  s.o = reinterpret_cast<bf16*>(p);
  p += 2 * BOX_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(p);
  s.q_full = bars;
  s.q_empty = bars + L::Q_STAGES;
  s.kv_full = bars + 2 * L::Q_STAGES;
  s.kv_empty = s.kv_full + L::KV_STAGES;
  return s;
}

template <int NC>
__device__ __forceinline__ void fence_all(float (&s)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) reg_fence(s[c]);
}

// The accumulators of chunks c0.. as one wider accumulator of N floats
// (chunk c is columns 64c..64c + 63, as in a 64 x 64c product).
template <int N, int NC>
__device__ __forceinline__ float (&wide(float (&s)[NC][32], int c0))[N] {
  return *reinterpret_cast<float(*)[N]>(&s[c0][0]);
}

// s[c] = q . k[chunk c]^T for this warpgroup's 64 rows and NC chunks of 64
// keys from `kd`, as few products as the widths allow (64 x 128 at NC = 2,
// 64 x 256 at 4, and 64 x 64 beside it at 5: q, re-read from shared memory
// by every product, is read once a k-step); four k-steps of 16 lanes, each
// 32 bytes further into the swizzle atom; waits for the products. The
// accumulators are zeroed first so that nothing of an earlier tile stays
// live across the loop.
template <int NC>
__device__ __forceinline__ void qk(float (&s)[NC][32], uint64_t qd,
                                   uint64_t kd) {
  static_assert(NC == 2 || NC == 4 || NC == 5, "chunks a sweep");
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[c][i] = 0.f;
  fence_all(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t q = qd + 2 * kk, k = kd + 2 * kk;
    if constexpr (NC == 2) {
      wgmma_m64n128k16_ss(wide<64>(s, 0), q, k, kk);
    } else {
      wgmma_m64n256k16_ss(wide<128>(s, 0), q, k, kk);
      if constexpr (NC == 5)
        wgmma_m64n64k16_ss(s[4], q, k + 4 * CHUNK_UNITS, kk);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(s);
}

// acc += p . v for NC chunks of keys from `vd`: four k-steps of 16 keys a
// chunk, each 16 rows (2048 bytes) further into the buffer; with ONES also
// lsum += p . 1 (B a block of bf16 ones at `onesd`), the row sums of the
// rounded p in fp32 (every column of lsum holds its row's sum); waits.
template <bool ONES, int NC>
__device__ __forceinline__ void pv(float (&acc)[32], float (&lsum)[4],
                                   uint32_t (&p)[NC][4][4], uint64_t vd,
                                   uint64_t onesd) {
  reg_fence(acc);
  reg_fence(lsum);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(p[c][kk]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs_tb(acc, p[c][kk], vd + 128 * (4 * c + kk), 1);
      if (ONES) wgmma_m64n8k16_rs(lsum, p[c][kk], onesd, 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(lsum);
}

// Row maxima over this lane's columns of a chunk whose first `valid` keys
// exist: mx[0][.] row g, mx[1][.] row g + 8 (accumulator element 4i + e is
// key 8i + 2t + e, rows g and g + 8 for e < 2 and e >= 2), spread over four
// partial maxima a row (by the chunk's parity and i's) so that no chain of
// dependent fmaxf is longer than 16.
template <bool MASK>
__device__ __forceinline__ void chunk_max(const float (&s)[32], int valid,
                                          int t, int part, float (&mx)[2][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (MASK && 8 * i >= valid) break;  // the rest of the chunk is padding
    const int key = 8 * i + 2 * t, j = part + (i & 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!MASK || key + e < valid) {
        mx[0][j] = fmaxf(mx[0][j], s[4 * i + e]);
        mx[1][j] = fmaxf(mx[1][j], s[4 * i + 2 + e]);
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void row_max(const float (&s)[NC][32], int valid,
                                        int t, float (&mx)[2][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int v = valid - c * CHUNK;
    if (v >= CHUNK)
      chunk_max<false>(s[c], CHUNK, t, 2 * (c & 1), mx);
    else if (v > 0)
      chunk_max<true>(s[c], v, t, 2 * (c & 1), mx);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// p = exp2((s - m)*c), formed as exp2(s*c - m*c) with one fma, rounded to
// bf16 and packed as the A fragments of the p.v product (k-step kk of the
// chunk: keys 16kk..16kk + 15, accumulator n8 blocks 2kk and 2kk + 1, so no
// shuffles); keys at or past `valid` get p = 0. GROUPED (K5) also sums the
// fp32 e into lp (row g, then row g + 8; four partial sums a row); K1's l,
// the sum of the rounded p, comes from the tensor cores (pv).
template <bool GROUPED, bool MASK>
__device__ __forceinline__ void chunk_exp(const float (&s)[32],
                                          uint32_t (&p)[4][4], int valid,
                                          int t, int part, float mc0,
                                          float mc1, float c,
                                          float (&lp)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (MASK && 16 * kk >= valid) {  // 16 keys of padding: no exp2
#pragma unroll
      for (int r = 0; r < 4; ++r) p[kk][r] = 0u;
      continue;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * kk + half, key = 8 * i + 2 * t, j = part + half;
      const bool ok0 = !MASK || key < valid, ok1 = !MASK || key + 1 < valid;
      const float e00 = ok0 ? fast_exp2(fmaf(s[4 * i], c, -mc0)) : 0.f;
      const float e01 = ok1 ? fast_exp2(fmaf(s[4 * i + 1], c, -mc0)) : 0.f;
      const float e10 = ok0 ? fast_exp2(fmaf(s[4 * i + 2], c, -mc1)) : 0.f;
      const float e11 = ok1 ? fast_exp2(fmaf(s[4 * i + 3], c, -mc1)) : 0.f;
      if (GROUPED) {
        lp[0][j] += e00 + e01;
        lp[1][j] += e10 + e11;
      }
      p[kk][2 * half] = bits(__floats2bfloat162_rn(e00, e01));      // row g
      p[kk][2 * half + 1] = bits(__floats2bfloat162_rn(e10, e11));  // g + 8
    }
  }
}

template <bool GROUPED, int NC>
__device__ __forceinline__ void row_exp(const float (&s)[NC][32],
                                        uint32_t (&p)[NC][4][4], int valid,
                                        int t, float mc0, float mc1, float c,
                                        float (&lp)[2][4]) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int v = valid - ch * CHUNK, part = 2 * (ch & 1);
    if (v >= CHUNK) {
      chunk_exp<GROUPED, false>(s[ch], p[ch], CHUNK, t, part, mc0, mc1, c,
                                lp);
    } else if (v > 0) {
      chunk_exp<GROUPED, true>(s[ch], p[ch], v, t, part, mc0, mc1, c, lp);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[ch][kk][r] = 0u;
    }
  }
}

__device__ __forceinline__ float max4(const float (&m)[4]) {
  return fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
}

// What a consumer's tile needs besides its registers.
struct Tile {
  uint64_t qd, kd, vd, onesd;  // descriptors: q tile, the item's K and V, ones
  uint64_t* q_empty;           // the q tile's slot, freed after the last q.k^T
  bf16* stage;                 // this warpgroup's o staging tile (8 KB)
  const CUtensorMap* o_map;
  int po, row, h, b;           // o's map order; the tile's first row, item
  float* st0;                  // K1: lse2; K5: m (null: no statistics)
  float* st1;                  // K5: l
  size_t stat_row;             // the item's first row in the statistics
};

// One consumer's 64-query tile of one (batch, head): o rows (staged in
// shared memory and stored by TMA, which drops rows past S) and their
// statistics.
template <int NC, bool MULTI, bool GROUPED>
__device__ __forceinline__ void tile(const Tile& a, int S, float c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + g;  // row g in the tile
  float s[NC][32];
  uint32_t p[NC][4][4];
  float acc[32], lsum[4];
  float mx[2][4], lp[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0][j] = mx[1][j] = -INFINITY;
    lp[0][j] = lp[1][j] = 0.f;
    lsum[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0, m1;
  constexpr uint64_t GROUP_UNITS = NC * CHUNK_UNITS;
  if constexpr (!MULTI) {
    // the whole row in registers: one q.k^T
    qk(s, a.qd, a.kd);
    mbar_arrive(a.q_empty);
    row_max(s, S, t, mx);
    m0 = quad_max(max4(mx[0]));
    m1 = quad_max(max4(mx[1]));
    row_exp<GROUPED>(s, p, S, t, m0 * c, m1 * c, c, lp);
    pv<!GROUPED>(acc, lsum, p, a.vd, a.onesd);
  } else {
    // groups of NC chunks, swept twice over the resident K
    const int groups = (S + NC * CHUNK - 1) / (NC * CHUNK);
    for (int gi = 0; gi < groups; ++gi) {
      qk(s, a.qd, a.kd + gi * GROUP_UNITS);
      row_max(s, S - gi * NC * CHUNK, t, mx);
    }
    m0 = quad_max(max4(mx[0]));
    m1 = quad_max(max4(mx[1]));
    for (int gi = 0; gi < groups; ++gi) {
      qk(s, a.qd, a.kd + gi * GROUP_UNITS);
      row_exp<GROUPED>(s, p, S - gi * NC * CHUNK, t, m0 * c, m1 * c, c, lp);
      pv<!GROUPED>(acc, lsum, p, a.vd + gi * GROUP_UNITS, a.onesd);
    }
    mbar_arrive(a.q_empty);
  }
  float l0, l1;
  if (GROUPED) {
    l0 = quad_sum((lp[0][0] + lp[0][1]) + (lp[0][2] + lp[0][3]));
    l1 = quad_sum((lp[1][0] + lp[1][1]) + (lp[1][2] + lp[1][3]));
  } else {
    l0 = lsum[0];
    l1 = lsum[2];
  }

  // o = acc * (1/l) in bf16 into the staging tile, in the 128-byte swizzle
  // of the map (16-byte column block i of row r at block i ^ (r & 7); rows
  // r and r + 8 share the pattern), once the store before it has read it
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const bool lead = (threadIdx.x & 127) == 0;
  if (lead) bulk_wait<0, true>();
  named_sync(1 + (threadIdx.x >> 7), 128);
  uint8_t* st = reinterpret_cast<uint8_t*>(a.stage) + r * ROW_BYTES + 4 * t;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int off = (i ^ (r & 7)) << 4;
    *reinterpret_cast<uint32_t*>(st + off) =
        pack_f32(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    *reinterpret_cast<uint32_t*>(st + 8 * ROW_BYTES + off) =
        pack_f32(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
  fence_async_smem();
  named_sync(1 + (threadIdx.x >> 7), 128);
  if (lead) {
    tma_store_view(a.o_map, a.stage, a.po, a.row, a.h, a.b);
    bulk_commit();
  }
  const int row0 = a.row + r;
  if (a.st0 != nullptr && t == 0) {
    const size_t row = a.stat_row + row0;
    if (GROUPED) {  // K5: the raw max and the sum before rounding
      if (row0 < S) { a.st0[row] = m0; a.st1[row] = l0; }
      if (row0 + 8 < S) { a.st0[row + 8] = m1; a.st1[row + 8] = l1; }
    } else {  // K1: lse2
      if (row0 < S) a.st0[row] = m0 * c + log2f(l0);
      if (row0 + 8 < S) a.st0[row + 8] = m1 * c + log2f(l1);
    }
  }
}

// st0, st1: K1 lse2 and null; K5 m and l; or both null (no statistics).
template <int NC, bool MULTI, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
    short_attn_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map,
                      float* __restrict__ st0, float* __restrict__ st1, int S,
                      int H, int items, int rows, float c, int perms) {
  using L = Layout<MULTI>;
  constexpr int KVS = L::KV_STAGES, QS = L::Q_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm = carve<MULTI>(smem_raw, rows);
  const int ntq = (S + TILE_Q - 1) / TILE_Q;  // q tiles an item
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QS; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], 128);
    }
    for (int i = 0; i < KVS; ++i) {
      mbar_init(&sm.kv_full[i], 1);
      mbar_init(&sm.kv_empty[i], ntq * 128);
    }
    fence_mbar_init();
  }
  if (threadIdx.x < CONSUMERS) {  // 1 KB of bf16 ones
    reinterpret_cast<uint32_t*>(sm.ones)[threadIdx.x] = 0x3F803F80u;
    fence_async_smem();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      const int pq = perms & 63, pk = (perms >> 6) & 63,
                pvm = (perms >> 12) & 63;
      int n = 0;  // the block's q tiles so far
      for (int j = 0, item = blockIdx.x; item < items;
           item += gridDim.x, ++j) {
        const int b = item / H, h = item % H;
        const int ks = j % KVS;
        mbar_wait(&sm.kv_empty[ks], ((j / KVS) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[ks], 2 * rows * ROW_BYTES);
        for (int r = 0; r < rows; r += 64) {
          tma_load_view(sm.k_at(ks) + r * 64, &k_map, &sm.kv_full[ks], pk, r,
                        h, b);
          tma_load_view(sm.v_at(ks) + r * 64, &v_map, &sm.kv_full[ks], pvm, r,
                        h, b);
        }
        for (int qt = 0; qt < ntq; ++qt, ++n) {
          const int qs = n % QS;
          mbar_wait(&sm.q_empty[qs], ((n / QS) & 1) ^ 1);
          mbar_expect_tx(&sm.q_full[qs], BOX_BYTES);
          tma_load_view(sm.q + qs * (BOX_BYTES / 2), &q_map, &sm.q_full[qs],
                        pq, qt * TILE_Q, h, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    Tile a;
    a.onesd = desc_b128(sm.ones, 16, 1024);
    a.stage = sm.o + wg * (BOX_BYTES / 2);
    a.o_map = &o_map;
    a.po = perms >> 18;
    a.st0 = st0;
    a.st1 = st1;
    int n = 0;
    for (int j = 0, item = blockIdx.x; item < items;
         item += gridDim.x, ++j) {
      a.b = item / H;
      a.h = item % H;
      const int ks = j % KVS;
      a.kd = desc_b128(sm.k_at(ks), 16, 1024);
      a.vd = desc_b128(sm.v_at(ks), 0, 1024);
      a.stat_row = ((size_t)a.b * H + a.h) * S;
      for (int qt = 0; qt < ntq; ++qt, ++n) {
        if ((n & 1) != wg) continue;
        const int qs = n % QS;
        mbar_wait(&sm.kv_full[ks], (j / KVS) & 1);
        mbar_wait(&sm.q_full[qs], (n / QS) & 1);
        a.qd = desc_b128(sm.q + qs * (BOX_BYTES / 2), 16, 1024);
        a.q_empty = &sm.q_empty[qs];
        a.row = qt * TILE_Q;
        tile<NC, MULTI, GROUPED>(a, S, c);
        mbar_arrive(&sm.kv_empty[ks]);
      }
    }
    if ((threadIdx.x & 127) == 0) bulk_wait<0, false>();  // o is written
  }
}

template <int NC, bool MULTI, bool GROUPED>
int launch(const CUtensorMap (&maps)[4], float* st0, float* st1, int B,
           int S, int H, int rows, float c, int perms, cudaStream_t stream) {
  auto kernel = short_attn_kernel<NC, MULTI, GROUPED>;
  const int smem = Layout<MULTI>::bytes(rows);
  static int allowed = 0;  // the shared memory this kernel may take so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const int items = B * H;
  const int grid = items < sm_count() ? items : sm_count();
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                          st0, st1, S, H, items, rows, c,
                                          perms);
  return (int)cudaGetLastError();
}

// The plan for S keys: NC chunks in registers (S <= 128: 2, <= 256: 4,
// <= 320: 5, one sweep), else 256-key groups swept twice; the key rows
// loaded cover every chunk a sweep takes.
template <bool GROUPED>
int run(const void* q, const void* k, const void* v, void* o, float* st0,
        float* st1, const long long* strides, int B, int S, int H, float c,
        void* stream) {
  if (S < 1 || S > MAX_SEQ || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int perm[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_view(&maps[i], ptrs[i], strides + 3 * i, B, H, S,
                                64, &perm[i], "unite_short_attn");
    if (err != 0) return err;
  }
  const int perms =
      perm[0] | (perm[1] << 6) | (perm[2] << 12) | (perm[3] << 18);
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= 2 * CHUNK)
    return launch<2, false, GROUPED>(maps, st0, st1, B, S, H, 2 * CHUNK, c,
                                     perms, st);
  if (S <= 4 * CHUNK)
    return launch<4, false, GROUPED>(maps, st0, st1, B, S, H, 4 * CHUNK, c,
                                     perms, st);
  if (S <= 5 * CHUNK)
    return launch<5, false, GROUPED>(maps, st0, st1, B, S, H, 5 * CHUNK, c,
                                     perms, st);
  const int rows = (S + GROUP - 1) / GROUP * GROUP;
  return launch<GROUP / CHUNK, true, GROUPED>(maps, st0, st1, B, S, H, rows,
                                              c, perms, st);
}

}  // namespace

// K1: q, k, v -> o, each a [B, H, S, 64] bf16 view (in practice the lane
// slices of qkv and out) whose (batch, head, row) strides in elements are
// strides[3i..3i+2] for i = q, k, v, o; lse [B, H, S] fp32 contiguous
// (lse2 = m*c + log2(l), l the sum of the rounded p), or null. c =
// scale*log2(e); 1 <= S <= 768. q, k and v need 16-byte aligned bases and
// strides that are multiples of 8 elements (for a dimension of extent > 1).
// Launches on `stream`; returns a CUDA error code.
extern "C" int unite_short_qkv_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse,
                                   const long long* strides, int B, int S,
                                   int H, float c, void* stream) {
  return run<false>(q, k, v, o, static_cast<float*>(lse), nullptr, strides, B,
                    S, H, c, stream);
}

// K5: the same views; m and l [B, H, S] fp32 contiguous (the raw row max of
// q.k^T and the row sum of the fp32 exp2((s - m)*c) before rounding), both
// null when the caller does not train.
extern "C" int unite_short_grouped_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* m,
                                       void* l, const long long* strides,
                                       int B, int S, int H, float c,
                                       void* stream) {
  return run<true>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
                   strides, B, S, H, c, stream);
}
