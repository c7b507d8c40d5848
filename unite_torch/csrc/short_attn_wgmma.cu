// Short-sequence attention forward for Hopper (sm_90a): one head's whole K
// and V resident in shared memory, on wgmma with TMA loads, a producer
// warp and persistent blocks. One kernel body serves two TPU kernels:
//
//   K1 replaces unite_tpu/ops/attention.py::_fused_qkv_kernel (called from
//      _fused_qkv_fwd): q, k, v are lane slices of the packed qkv
//      [B, S, 3*H*D] and o is written into [B, S, H*D], D = 64 or 80
//      (up to 512 keys at 80); l is the row sum
//      of the ROUNDED p, and the base-2 row log-sum-exp lse2 = m*c + log2(l)
//      is saved, [B, H, S] fp32, when the caller trains (K2 reads it);
//   K5 replaces unite_tpu/ops/attention.py::_grouped_fwd_kernel (called
//      from _grouped_attention_fwd): q, k, v and o are [B, H, S, D] views,
//      D = 64 or 80 (up to 512 keys at 80); l is the row sum of the fp32
//      e = exp2((s - m)*c) BEFORE rounding, and the raw row max m and l are
//      saved, [B, H, S] fp32 each, when the caller trains
//      (csrc/short_bwd_wgmma.cu reads them).
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
// or 16 heads; 392 keys for K5) a head does 4*S^2*D flops on 4*S*D*2
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
// Head dim 80 (the kernel is templated on D; D = 64 is the body above):
// lanes 64-79 of every q, k, v and o row go through a second map into
// tiles of 32-byte rows (32-byte swizzle) beside the 64-lane ones; q.k^T
// takes a fifth k-step on them, p.v a second product (m64n16k16, v's 16
// lanes MN-major, 8 more accumulators a thread), and o's lanes 64-79 are
// staged and stored by TMA through their own map. K and V then take 160
// bytes a key: one buffer of them (not two) at 257-320 keys, and at most
// 512 keys (206 KB; 768 would need 240 KB of K and V).
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
// D = 80: lanes 64-79 of a row, of a 64-row box and of a chunk
constexpr int TAIL_ROW = 16 * 2;
constexpr int TAIL_BOX = 64 * TAIL_ROW;  // 2 KB
constexpr uint64_t CHUNK_TAIL_UNITS = (CHUNK * TAIL_ROW) >> 4;

// The longest sequence a head dim takes (K and V of a head resident).
template <int D>
constexpr int max_seq() {
  return D == 80 ? 512 : 768;
}

// The shared-memory plan of a launch: MULTI sweeps groups of 256 keys
// twice; `rows` key rows are loaded (a multiple of the keys a sweep takes,
// so every row a product reads is loaded) into KV_STAGES buffers; q tiles
// come through a ring of Q_STAGES; 1 KB of bf16 ones is the B operand of
// the row sums; each consumer stages its o tile in 8 KB of its own. 768
// keys take 231,472 bytes of the 232,448 a block may have. At D = 80 each
// row, box and staging tile has a 32-byte-row tail beside it, and one KV
// buffer serves 320 keys as well.
template <int NC, bool MULTI, int D>
struct Layout {
  static constexpr int KV_STAGES = MULTI || (D == 80 && NC == 5) ? 1 : 2;
  static constexpr int Q_STAGES = MULTI ? 2 : 4;
  static constexpr int TROW = D == 80 ? TAIL_ROW : 0;
  static constexpr int TBOX = D == 80 ? TAIL_BOX : 0;
  static __host__ __device__ int bytes(int rows) {
    return 1024 + 1024 + KV_STAGES * 2 * rows * (ROW_BYTES + TROW) +
           (Q_STAGES + 2) * (BOX_BYTES + TBOX) +
           8 * 2 * (Q_STAGES + KV_STAGES);
  }
};

// The lanes-64-79 maps of q, k, v and o at D = 80 (none at 64).
template <int D>
struct TailMaps {
  CUtensorMap q, k, v, o;
};
template <>
struct TailMaps<64> {};

struct Smem {
  bf16* ones;  // 512 bf16 ones
  bf16* k;     // KV_STAGES buffers of `rows` rows
  bf16* v;
  bf16* q;     // Q_STAGES tiles
  bf16* o;     // two staging tiles, one a consumer
  bf16* kt;    // D = 80: lanes 64-79 of each, laid out as they are
  bf16* vt;
  bf16* qt;
  bf16* ot;
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
  __device__ __forceinline__ bf16* kt_at(int st) const {
    return kt + (size_t)st * rows * 16;
  }
  __device__ __forceinline__ bf16* vt_at(int st) const {
    return vt + (size_t)st * rows * 16;
  }
};

template <int NC, bool MULTI, int D>
__device__ __forceinline__ Smem carve(uint8_t* raw, int rows) {
  using L = Layout<NC, MULTI, D>;
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
  s.kt = s.vt = s.qt = s.ot = nullptr;
  if (D == 80) {  // each a multiple of 2 KB from a 1024-aligned start
    s.kt = reinterpret_cast<bf16*>(p);
    p += L::KV_STAGES * rows * TAIL_ROW;
    s.vt = reinterpret_cast<bf16*>(p);
    p += L::KV_STAGES * rows * TAIL_ROW;
    s.qt = reinterpret_cast<bf16*>(p);
    p += L::Q_STAGES * TAIL_BOX;
    s.ot = reinterpret_cast<bf16*>(p);
    p += 2 * TAIL_BOX;
  }
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
// 32 bytes further into the swizzle atom, and at D = 80 a fifth on the
// 32-byte tiles (qtd, ktd); waits for the products. The accumulators are
// zeroed first so that nothing of an earlier tile stays live across the
// loop.
template <int NC, int D>
__device__ __forceinline__ void qk(float (&s)[NC][32], uint64_t qd,
                                   uint64_t kd, uint64_t qtd, uint64_t ktd) {
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
  if constexpr (D == 80) {
    if constexpr (NC == 2) {
      wgmma_m64n128k16_ss(wide<64>(s, 0), qtd, ktd, 1);
    } else {
      wgmma_m64n256k16_ss(wide<128>(s, 0), qtd, ktd, 1);
      if constexpr (NC == 5)
        wgmma_m64n64k16_ss(s[4], qtd, ktd + 4 * CHUNK_TAIL_UNITS, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(s);
}

// acc += p . v for NC chunks of keys from `vd`: four k-steps of 16 keys a
// chunk, each 16 rows (2048 bytes) further into the buffer; at D = 80 also
// acc_t += p . v's lanes 64-79 (vtd, 16 rows of 32 bytes a k-step); with
// ONES also lsum += p . 1 (B a block of bf16 ones at `onesd`), the row
// sums of the rounded p in fp32 (every column of lsum holds its row's
// sum); waits.
template <bool ONES, int NC, int D, int NT>
__device__ __forceinline__ void pv(float (&acc)[32], float (&acc_t)[NT],
                                   float (&lsum)[4], uint32_t (&p)[NC][4][4],
                                   uint64_t vd, uint64_t vtd, uint64_t onesd) {
  reg_fence(acc);
  if constexpr (D == 80) reg_fence(acc_t);
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
      if constexpr (D == 80)
        wgmma_m64n16k16_rs_tb(acc_t, p[c][kk], vtd + 32 * (4 * c + kk), 1);
      if (ONES) wgmma_m64n8k16_rs(lsum, p[c][kk], onesd, 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  if constexpr (D == 80) reg_fence(acc_t);
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

// p for NC chunks of keys (chunk_exp), K5's sums in four partial sums a row,
// or with TWO (D = 80) in two: beside the 80-lane accumulators four
// spilled 12 bytes at 320 keys.
template <bool GROUPED, int NC, bool TWO>
__device__ __forceinline__ void row_exp(const float (&s)[NC][32],
                                        uint32_t (&p)[NC][4][4], int valid,
                                        int t, float mc0, float mc1, float c,
                                        float (&lp)[2][4]) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int v = valid - ch * CHUNK, part = TWO ? 0 : 2 * (ch & 1);
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
  uint64_t qtd, ktd, vtd;      // D = 80: lanes 64-79 of the q tile, K and V
  uint64_t* q_empty;           // the q tile's slot, freed after the last q.k^T
  bf16* stage;                 // this warpgroup's o staging tile (8 KB)
  bf16* stage_t;               // D = 80: its lanes 64-79 (2 KB)
  const CUtensorMap* o_map;
  const CUtensorMap* ot_map;   // D = 80: o's lanes 64-79
  int po, row, h, b;           // o's map order; the tile's first row, item
  float* st0;                  // K1: lse2; K5: m (null: no statistics)
  float* st1;                  // K5: l
  size_t stat_row;             // the item's first row in the statistics
};

// One consumer's 64-query tile of one (batch, head): o rows (staged in
// shared memory and stored by TMA, which drops rows past S) and their
// statistics.
template <int NC, bool MULTI, bool GROUPED, int D>
__device__ __forceinline__ void tile(const Tile& a, int S, float c) {
  constexpr int NT = tail_regs<D>();  // o's lanes 64-79
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + g;  // row g in the tile
  float s[NC][32];
  uint32_t p[NC][4][4];
  float acc[32], acc_t[NT], lsum[4];
  float mx[2][4], lp[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0][j] = mx[1][j] = -INFINITY;
    lp[0][j] = lp[1][j] = 0.f;
    lsum[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) acc_t[i] = 0.f;
  float m0, m1;
  constexpr uint64_t GROUP_UNITS = NC * CHUNK_UNITS;
  constexpr uint64_t GROUP_TAIL_UNITS = NC * CHUNK_TAIL_UNITS;
  if constexpr (!MULTI) {
    // the whole row in registers: one q.k^T
    qk<NC, D>(s, a.qd, a.kd, a.qtd, a.ktd);
    mbar_arrive(a.q_empty);
    row_max(s, S, t, mx);
    m0 = quad_max(max4(mx[0]));
    m1 = quad_max(max4(mx[1]));
    row_exp<GROUPED, NC, D == 80>(s, p, S, t, m0 * c, m1 * c, c, lp);
    pv<!GROUPED, NC, D>(acc, acc_t, lsum, p, a.vd, a.vtd, a.onesd);
  } else {
    // groups of NC chunks, swept twice over the resident K
    const int groups = (S + NC * CHUNK - 1) / (NC * CHUNK);
    for (int gi = 0; gi < groups; ++gi) {
      qk<NC, D>(s, a.qd, a.kd + gi * GROUP_UNITS, a.qtd,
                a.ktd + gi * GROUP_TAIL_UNITS);
      row_max(s, S - gi * NC * CHUNK, t, mx);
    }
    m0 = quad_max(max4(mx[0]));
    m1 = quad_max(max4(mx[1]));
    for (int gi = 0; gi < groups; ++gi) {
      qk<NC, D>(s, a.qd, a.kd + gi * GROUP_UNITS, a.qtd,
                a.ktd + gi * GROUP_TAIL_UNITS);
      row_exp<GROUPED, NC, D == 80>(s, p, S - gi * NC * CHUNK, t, m0 * c, m1 * c, c, lp);
      pv<!GROUPED, NC, D>(acc, acc_t, lsum, p, a.vd + gi * GROUP_UNITS,
                          a.vtd + gi * GROUP_TAIL_UNITS, a.onesd);
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
  if constexpr (D == 80) {
    // lanes 64-79 in the 32-byte swizzle (16-byte column block i of row r
    // at block i ^ ((r >> 2) & 1); rows r and r + 8 share the pattern)
    uint8_t* stt = reinterpret_cast<uint8_t*>(a.stage_t) + r * TAIL_ROW + 4 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (i ^ ((r >> 2) & 1)) << 4;
      *reinterpret_cast<uint32_t*>(stt + off) =
          pack_f32(acc_t[4 * i] * inv0, acc_t[4 * i + 1] * inv0);
      *reinterpret_cast<uint32_t*>(stt + 8 * TAIL_ROW + off) =
          pack_f32(acc_t[4 * i + 2] * inv1, acc_t[4 * i + 3] * inv1);
    }
  }
  fence_async_smem();
  named_sync(1 + (threadIdx.x >> 7), 128);
  if (lead) {
    tma_store_view(a.o_map, a.stage, a.po, a.row, a.h, a.b);
    if constexpr (D == 80)
      tma_store_view(a.ot_map, a.stage_t, a.po, a.row, a.h, a.b);
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

// A producer thread: for each of the block's items, once its buffer is
// free, TMA loads of the item's whole K and V, then of its q tiles into the
// ring. TAIL: lanes 64-79 (D = 80) into their tiles, through the tail maps,
// by a second thread beside the first (each full barrier then counts two
// arrivals): one thread issuing both spilled even at 40 registers.
template <int NC, bool MULTI, int D, bool TAIL>
__device__ __forceinline__ void produce(const Smem& sm, const CUtensorMap* q_map,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, int perms,
                                        int H, int items, int rows, int ntq) {
  using L = Layout<NC, MULTI, D>;
  constexpr int KVS = L::KV_STAGES, QS = L::Q_STAGES;
  constexpr int ROW = TAIL ? TAIL_ROW : ROW_BYTES;  // bytes a row and a box
  constexpr int BOX = TAIL ? TAIL_BOX : BOX_BYTES;
  bf16* const k = TAIL ? sm.kt : sm.k;
  bf16* const v = TAIL ? sm.vt : sm.v;
  bf16* const q = TAIL ? sm.qt : sm.q;
  tma_prefetch(q_map);
  tma_prefetch(k_map);
  tma_prefetch(v_map);
  const int pq = perms & 63, pk = (perms >> 6) & 63, pvm = (perms >> 12) & 63;
  int n = 0;  // the block's q tiles so far
  for (int j = 0, item = blockIdx.x; item < items; item += gridDim.x, ++j) {
    const int b = item / H, h = item % H;
    const int ks = j % KVS;
    mbar_wait(&sm.kv_empty[ks], ((j / KVS) & 1) ^ 1);
    mbar_expect_tx(&sm.kv_full[ks], 2 * rows * ROW);
    for (int r = 0; r < rows; r += 64) {
      const size_t at = ((size_t)ks * rows + r) * (ROW / 2);
      tma_load_view(k + at, k_map, &sm.kv_full[ks], pk, r, h, b);
      tma_load_view(v + at, v_map, &sm.kv_full[ks], pvm, r, h, b);
    }
    for (int qt = 0; qt < ntq; ++qt, ++n) {
      const int qs = n % QS;
      mbar_wait(&sm.q_empty[qs], ((n / QS) & 1) ^ 1);
      mbar_expect_tx(&sm.q_full[qs], BOX);
      tma_load_view(q + qs * (BOX / 2), q_map, &sm.q_full[qs], pq,
                    qt * TILE_Q, h, b);
    }
  }
}

// st0, st1: K1 lse2 and null; K5 m and l; or both null (no statistics).
template <int NC, bool MULTI, bool GROUPED, int D>
__global__ void __launch_bounds__(THREADS, 1)
    short_attn_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map,
                      const __grid_constant__ TailMaps<D> tails,
                      float* __restrict__ st0, float* __restrict__ st1, int S,
                      int H, int items, int rows, float c, int perms) {
  using L = Layout<NC, MULTI, D>;
  constexpr int KVS = L::KV_STAGES, QS = L::Q_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm = carve<NC, MULTI, D>(smem_raw, rows);
  const int ntq = (S + TILE_Q - 1) / TILE_Q;  // q tiles an item
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QS; ++i) {
      mbar_init(&sm.q_full[i], D == 80 ? 2 : 1);  // a producer thread each
      mbar_init(&sm.q_empty[i], 128);
    }
    for (int i = 0; i < KVS; ++i) {
      mbar_init(&sm.kv_full[i], D == 80 ? 2 : 1);
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
    // D = 80: the two producer threads' tail pointers and maps take the
    // producer warpgroup to 40 registers (24 spilled), the consumers to 232
    if constexpr (D == 80)
      setmaxnreg_dec<40>();
    else
      setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS)
      produce<NC, MULTI, D, false>(sm, &q_map, &k_map, &v_map, perms, H,
                                   items, rows, ntq);
    if constexpr (D == 80) {
      if (threadIdx.x == CONSUMERS + 32)
        produce<NC, MULTI, D, true>(sm, &tails.q, &tails.k, &tails.v, perms,
                                    H, items, rows, ntq);
    }
  } else {
    // ------------------------------------------------------ consumers
    if constexpr (D == 80)
      setmaxnreg_inc<232>();
    else
      setmaxnreg_inc<240>();
    Tile a;
    a.onesd = desc_b128(sm.ones, 16, 1024);
    a.stage = sm.o + wg * (BOX_BYTES / 2);
    a.o_map = &o_map;
    a.qtd = a.ktd = a.vtd = 0;
    a.stage_t = nullptr;
    a.ot_map = nullptr;
    if constexpr (D == 80) {
      a.stage_t = sm.ot + wg * (TAIL_BOX / 2);
      a.ot_map = &tails.o;
    }
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
      if constexpr (D == 80) {
        a.ktd = desc_b32(sm.kt_at(ks), 16, 256);
        a.vtd = desc_b32(sm.vt_at(ks), 0, 256);
      }
      a.stat_row = ((size_t)a.b * H + a.h) * S;
      for (int qt = 0; qt < ntq; ++qt, ++n) {
        if ((n & 1) != wg) continue;
        const int qs = n % QS;
        mbar_wait(&sm.kv_full[ks], (j / KVS) & 1);
        mbar_wait(&sm.q_full[qs], (n / QS) & 1);
        a.qd = desc_b128(sm.q + qs * (BOX_BYTES / 2), 16, 1024);
        if constexpr (D == 80)
          a.qtd = desc_b32(sm.qt + qs * (TAIL_BOX / 2), 16, 256);
        a.q_empty = &sm.q_empty[qs];
        a.row = qt * TILE_Q;
        tile<NC, MULTI, GROUPED, D>(a, S, c);
        mbar_arrive(&sm.kv_empty[ks]);
      }
    }
    if ((threadIdx.x & 127) == 0) bulk_wait<0, false>();  // o is written
  }
}

template <int NC, bool MULTI, bool GROUPED, int D>
int launch(const CUtensorMap (&maps)[4], const TailMaps<D>& tails,
           float* st0, float* st1, int B, int S, int H, int rows, float c,
           int perms, cudaStream_t stream) {
  auto kernel = short_attn_kernel<NC, MULTI, GROUPED, D>;
  const int smem = Layout<NC, MULTI, D>::bytes(rows);
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
                                          tails, st0, st1, S, H, items, rows,
                                          c, perms);
  return (int)cudaGetLastError();
}

// The plan for S keys: NC chunks in registers (S <= 128: 2, <= 256: 4,
// <= 320: 5, one sweep), else 256-key groups swept twice; the key rows
// loaded cover every chunk a sweep takes.
template <bool GROUPED, int D>
int run(const void* q, const void* k, const void* v, void* o, float* st0,
        float* st1, const long long* strides, int B, int S, int H, float c,
        void* stream) {
  if (S < 1 || S > max_seq<D>() || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4], tmaps[4];
  TailMaps<D> tails;
  int perm[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_view_d(&maps[i], &tmaps[i], D, ptrs[i],
                                  strides + 3 * i, B, H, S, 64, &perm[i],
                                  "unite_short_attn");
    if (err != 0) return err;
  }
  if constexpr (D == 80) {
    tails.q = tmaps[0];
    tails.k = tmaps[1];
    tails.v = tmaps[2];
    tails.o = tmaps[3];
  }
  const int perms =
      perm[0] | (perm[1] << 6) | (perm[2] << 12) | (perm[3] << 18);
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= 2 * CHUNK)
    return launch<2, false, GROUPED, D>(maps, tails, st0, st1, B, S, H,
                                        2 * CHUNK, c, perms, st);
  if (S <= 4 * CHUNK)
    return launch<4, false, GROUPED, D>(maps, tails, st0, st1, B, S, H,
                                        4 * CHUNK, c, perms, st);
  if (S <= 5 * CHUNK)
    return launch<5, false, GROUPED, D>(maps, tails, st0, st1, B, S, H,
                                        5 * CHUNK, c, perms, st);
  const int rows = (S + GROUP - 1) / GROUP * GROUP;
  return launch<GROUP / CHUNK, true, GROUPED, D>(maps, tails, st0, st1, B, S,
                                                 H, rows, c, perms, st);
}

}  // namespace

// K1: q, k, v -> o, each a [B, H, S, D] bf16 view (in practice the lane
// slices of qkv and out) whose (batch, head, row) strides in elements are
// strides[3i..3i+2] for i = q, k, v, o; lse [B, H, S] fp32 contiguous
// (lse2 = m*c + log2(l), l the sum of the rounded p), or null. c =
// scale*log2(e); D = 64 with 1 <= S <= 768, or D = 80 with 1 <= S <= 512
// (cudaErrorInvalidValue otherwise). q, k and v need 16-byte aligned bases
// and strides that are multiples of 8 elements (for a dimension of extent
// > 1). Launches on `stream`; returns a CUDA error code.
extern "C" int unite_short_qkv_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse,
                                   const long long* strides, int B, int S,
                                   int H, int D, float c, void* stream) {
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return run<false, 64>(q, k, v, o, l, nullptr, strides, B, S, H, c,
                          stream);
  if (D == 80)
    return run<false, 80>(q, k, v, o, l, nullptr, strides, B, S, H, c,
                          stream);
  return (int)cudaErrorInvalidValue;
}

// K5: the same views and head dims, D = 64 with 1 <= S <= 768 or D = 80
// with 1 <= S <= 512 (a head's K and V resident: 192 KB at 768 keys of 64
// lanes, 160 KB at 512 of 80; cudaErrorInvalidValue otherwise); m and l
// [B, H, S] fp32 contiguous (the raw row max of q.k^T and the row sum of
// the fp32 exp2((s - m)*c) before rounding), both null when the caller does
// not train.
extern "C" int unite_short_grouped_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* m,
                                       void* l, const long long* strides,
                                       int B, int S, int H, int D, float c,
                                       void* stream) {
  float* mx = static_cast<float*>(m);
  float* sum = static_cast<float*>(l);
  if (D == 64)
    return run<true, 64>(q, k, v, o, mx, sum, strides, B, S, H, c, stream);
  if (D == 80)
    return run<true, 80>(q, k, v, o, mx, sum, strides, B, S, H, c, stream);
  return (int)cudaErrorInvalidValue;
}
