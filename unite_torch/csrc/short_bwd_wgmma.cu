// Short-sequence attention backward for Hopper (sm_90a): one head's whole
// streamed side resident in shared memory, on wgmma with TMA loads, a
// producer warp and persistent blocks, as two kernels in the
// FlashAttention-2 split (dq, then dk and dv, on one stream). One body of
// each serves two TPU kernels:
//
//   K2 replaces unite_tpu/ops/attention.py::_fused_qkv_bwd_kernel (called
//      from _fused_qkv_bwd): q, k, v, o and do are lane slices of the
//      packed qkv [B, S, 3*H*D] and [B, S, H*D], and dq, dk, dv are
//      written straight into the lane slices of the packed dqkv, at D = 64
//      or 80 (up to 512 keys at 80);
//   K5's backward replaces unite_tpu/ops/attention.py::_grouped_bwd_kernel
//      (called from _grouped_attention_bwd): every tensor is a [B, H, S, D]
//      view, contiguous or strided, D = 64 or 80 (392 = stage 1 at mask
//      0.75, and the huge VideoMAE's encoder at mask 0.75).
//
// K2, from the forward's base-2 row log-sum-exp lse2 (K1's) [B, H, S]:
//   dq   delta = rowsum(do * o)              fp32, written for dkv
//        p  = exp2(q.k^T * c - lse2)         fp32
//        ds = p * (dp - delta), dp = do.v^T  rounded to bf16
//        dq = ds.k * scale                   scale on the fp32 sum
//   dkv  p^T = exp2(k.q^T * c - lse2)        fp32; dv = bf16(p^T).do
//        ds^T = p^T * (dp^T - delta)         from the fp32 p^T, rounded
//        dk = ds^T.q * scale
// (the port's K2 since it was first ported: p from the lse, not the TPU's
// m and its own row sum; held against the plain version at BWD_TOL).
// K5, from the forward's raw row max m and row sum l [B, H, S], with the
// TPU kernel's rounding points (:472-505):
//   e = exp2((s - m)*c), s = q.k^T, fp32 against the exact m; il = 1/l
//   dq   delta = rowsum(e * dp) * il         a first sweep, written for dkv
//        dq = bf16(e * (dp - delta)).k * (scale * il)
//   dkv  dv = bf16(e)^T . bf16(do * il)
//        dk = bf16(e * (dp - delta) * il)^T . q * scale
// c = scale*log2(e); exp2's argument is one fma, s*c - m*c.
//
// What bounds it on the H100: at the main-path shapes (320 keys, 12 or 16
// heads, K2; 392 keys, K5) a head does 7 (K2) or 9 (K5) products of
// 2*S^2*64 flops on about 10 bf16 [S, 64] tensors read or written: about
// 0.7*S flops a byte (220-280), under the card's ridge of about 295, so
// bytes and operations are close, and only wgmma reaches the tensor
// cores' rate. The design:
// * two kernels (dq; dk and dv), each with a block per SM that walks a
//   contiguous range of the flattened (batch, head, 64-row tile) order, so
//   the blocks' work differs by at most one tile at any batch;
// * the side every tile of a head reads (dq: k and v; dkv: q and do, and
//   for K5 bf16(do * il)) is resident in shared memory for the head, in
//   64-row chunks with a full and an empty barrier each: the producer
//   thread loads a chunk by TMA (128-byte swizzle, rows past S zero-filled)
//   as soon as the two consumers' last tiles of the previous head are done
//   with it, so the next head arrives chunk by chunk under the last tiles'
//   products; K5's second dq sweep re-reads the resident k and v, tensor-
//   core time and no bytes;
// * two consumer warpgroups take the range's tiles in turn; each reads its
//   tile's 64 rows (dq: q and do; dkv: k and v) from a ring of TMA slots
//   (two, or one where shared memory is short: dk/dv at K5's 512 and K2's
//   768 keys) once, into wgmma A fragments, and frees the slot at once
//   (release_slot); setmaxnreg moves registers from the producer to them;
// * per 64-row chunk, the score products (s and dp, or s^T and dp^T) are
//   wgmma m64n64k16 with A from registers and the chunk K-major; p and ds
//   are formed on the fp32 accumulators, rounded a pair at a time by one
//   packed conversion into the A fragments of the gradient products, which
//   read the same chunk MN-major; chunk j + 1's score products run while
//   chunk j's gradient products do, and each accumulator is read only
//   after the wait that retires its product (csrc/attn_bwd_wgmma.cuh);
// * in dkv, two producer warps prepare each resident chunk's column
//   statistics (K2: lse2, delta; K5: m*c, il, delta), with queries past S
//   given an lse2 or m*c of +inf (so p^T = e = 0 exactly) and il = delta =
//   0, and K5's bf16(do * il) once a head, not once a key tile.
// Ragged edges: keys past S get p = e = 0 in dq, and a last chunk of at
// most 16 keys (392 = 6*64 + 8) takes products 16 keys wide; rows past S
// are computed on zero rows and never stored.
// Head dim 80 (the kernels are templated on D, and D = 64 is the body
// above): lanes 64-79 of every tile and chunk come through a second map
// into tiles of 32-byte rows (32-byte swizzle); a tile's are read into one
// more A fragment a tensor (the fifth k-step of its score products), a
// chunk's are the B operand of that k-step and of a second gradient
// product, m64n16k16, into 8 more accumulators a thread. K5's dk/dv kernel
// cannot keep a third resident tensor there: q, do and bf16(do * il) of
// 512 keys take 3 * 8 * 10,240 = 245,760 bytes, above the 232,448 a block
// may have. So at D = 80 only q and do are resident, and each consumer
// reads bf16(do * il) of the chunk in hand from a tile of its own, which
// a prep warp of its own writes (do's rows times il, rounded as at
// D = 64) while the consumer's score products run, handed over by a full
// and an empty barrier: the same rounding point, computed once a tile and
// chunk instead of once a head and chunk. (The consumers cannot compute it
// themselves: beside the 80-lane accumulators and fragments that spilled
// at 232 registers, and the prep warps spill at 24.)
#include "attn_bwd_wgmma.cuh"
#include "fused_qkv_common.cuh"
#include "hopper.cuh"

using namespace unite;
using namespace hopper;
using namespace attn_bwd;

namespace {

constexpr int TILE = 64;                     // rows a tile and a chunk
constexpr int TILE_BYTES = TILE * 64 * 2;    // one 64-row bf16 tile: 8 KB
constexpr uint64_t TILE_UNITS = TILE_BYTES >> 4;  // in descriptor units
constexpr int CONSUMERS = 256;               // threads of the two consumers
constexpr int THREADS = CONSUMERS + 128;     // and the producer warpgroup
constexpr int PREP = 64;                     // dkv: threads of the prep warps
constexpr int SMEM_MAX = 232448;             // what a block may have
// D = 80: lanes 64-79 of a 64-row tile or chunk, 32-byte rows
constexpr int TAIL_BYTES = TILE * 16 * 2;
constexpr uint64_t TAIL_UNITS = TAIL_BYTES >> 4;

// The longest sequence a head dim takes (a head's resident side).
template <int D>
constexpr int max_seq() {
  return D == 80 ? 512 : 768;
}

// The shared-memory plan of a launch: `res` resident tensors of `nch`
// 64-row chunks (dq: k, v; dkv: q, do, and at D = 64 K5's bf16(do * il)),
// `nstat` column statistics of 64 values a chunk (dkv), a ring of `qs`
// slots of two 64-row tiles (dq: q, do; dkv: k, v), `own` tiles of each
// consumer's own (K5's dkv at D = 80: bf16(do * il) of the chunk in hand)
// with a full and an empty barrier each, and the barriers; at D = 80 a
// tail of lanes 64-79 beside each chunk and tile.
struct Plan {
  int nch, res, nstat, qs, own;
  template <int D>
  __host__ __device__ int bytes() const {
    return 1024 +
           (res * nch + 2 * qs + 2 * own) *
               (TILE_BYTES + (D == 80 ? TAIL_BYTES : 0)) +
           nstat * nch * TILE * 4 + 8 * (3 * nch + 2 + qs + 4 * own);
  }
};

// The lanes-64-79 maps of q, k, v and do at D = 80 (none at 64).
template <int D>
struct TailMaps {
  CUtensorMap q, k, v, dout;
};
template <>
struct TailMaps<64> {};

struct Smem {
  uint8_t* res;       // tensor r's chunk c at (r * nch + c) tiles
  uint8_t* ring;      // slot s's two tiles at 2s, 2s + 1
  uint8_t* own;       // D = 80, K5's dkv: consumer w's tile at w
  uint8_t* res_t;     // D = 80: lanes 64-79 of each, laid out as they are
  uint8_t* ring_t;
  uint8_t* own_t;
  float* stats;       // statistic k of chunk c at (k * nch + c) * 64
  uint64_t* full;     // a chunk's TMA loads, nch
  uint64_t* prep;     // dkv: a chunk's statistics (and K5's do * il), nch
  uint64_t* empty;    // a chunk's last reads of a head, nch
  uint64_t* t_full;   // a tile's loads, one barrier a consumer (2)
  uint64_t* t_empty;  // a ring slot read into registers, qs
  uint64_t* own_full;   // consumer w's own tile written, at w (own)
  uint64_t* own_empty;  // ... and read by its products, at w
  int nch;
  __device__ __forceinline__ bf16* chunk(int r, int c) const {
    return reinterpret_cast<bf16*>(res + (size_t)(r * nch + c) * TILE_BYTES);
  }
  __device__ __forceinline__ bf16* slot(int s, int i) const {
    return reinterpret_cast<bf16*>(ring + (size_t)(2 * s + i) * TILE_BYTES);
  }
  __device__ __forceinline__ bf16* chunk_t(int r, int c) const {
    return reinterpret_cast<bf16*>(res_t + (size_t)(r * nch + c) * TAIL_BYTES);
  }
  __device__ __forceinline__ bf16* slot_t(int s, int i) const {
    return reinterpret_cast<bf16*>(ring_t + (size_t)(2 * s + i) * TAIL_BYTES);
  }
  __device__ __forceinline__ float* stat(int k, int c) const {
    return stats + (k * nch + c) * TILE;
  }
  __device__ __forceinline__ bf16* own_tile(int w) const {
    return reinterpret_cast<bf16*>(own + (size_t)w * TILE_BYTES);
  }
  __device__ __forceinline__ bf16* own_tile_t(int w) const {
    return reinterpret_cast<bf16*>(own_t + (size_t)w * TAIL_BYTES);
  }
};

template <int D>
__device__ __forceinline__ Smem carve(uint8_t* raw, const Plan& pl) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  uint8_t* p = raw + pad;
  Smem s;
  s.nch = pl.nch;
  s.res = p;
  p += pl.res * pl.nch * TILE_BYTES;
  s.ring = p;
  p += 2 * pl.qs * TILE_BYTES;
  s.own = s.res_t = s.ring_t = s.own_t = nullptr;
  if (D == 80) {  // multiples of 8 KB, then of 2 KB, from a 1024-aligned start
    s.own = p;
    p += 2 * pl.own * TILE_BYTES;
    s.res_t = p;
    p += pl.res * pl.nch * TAIL_BYTES;
    s.ring_t = p;
    p += 2 * pl.qs * TAIL_BYTES;
    s.own_t = p;
    p += 2 * pl.own * TAIL_BYTES;
  }
  s.stats = reinterpret_cast<float*>(p);
  p += pl.nstat * pl.nch * TILE * 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(p);
  s.full = bars;
  s.prep = bars + pl.nch;
  s.empty = bars + 2 * pl.nch;
  s.t_full = bars + 3 * pl.nch;
  s.t_empty = s.t_full + 2;
  s.own_full = s.t_empty + pl.qs;
  s.own_empty = s.own_full + 2;
  return s;
}

// The block's tiles: [t0, t1) of the flattened (batch * H + head, tile)
// order of `ntiles`.
__device__ __forceinline__ void block_range(int ntiles, int& t0, int& t1) {
  t0 = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  t1 = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
}

__device__ __forceinline__ void init_barriers(const Smem& sm, const Plan& pl,
                                              bool prep) {
  if (threadIdx.x == 0) {
    for (int c = 0; c < pl.nch; ++c) {
      mbar_init(&sm.full[c], 1);
      if (prep) mbar_init(&sm.prep[c], PREP);
      mbar_init(&sm.empty[c], CONSUMERS);
    }
    mbar_init(&sm.t_full[0], 1);
    mbar_init(&sm.t_full[1], 1);
    for (int s = 0; s < pl.qs; ++s) mbar_init(&sm.t_empty[s], 128);
    for (int w = 0; w < (pl.own ? 2 : 0); ++w) {
      mbar_init(&sm.own_full[w], PREP / 2);  // its prep warp
      mbar_init(&sm.own_empty[w], 128);      // its consumer
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// The producer thread. For each head of the block's range: the first qs
// tiles' two boxes (their slots are freed by the tiles before them, which
// need nothing of this head), then the head's resident chunks (each once
// both consumers are done with it for the head before), then the rest of
// its tiles. r0, r1: the resident maps; m0, m1: the tiles' maps; each
// with its map order; at D = 80 each with its lanes-64-79 map in `tl`
// (r0, r1, m0, m1).
template <int D>
__device__ __forceinline__ void produce(const Smem& sm, const Plan& pl,
                                        const CUtensorMap* r0, int pr0,
                                        const CUtensorMap* r1, int pr1,
                                        const CUtensorMap* m0, int pm0,
                                        const CUtensorMap* m1, int pm1,
                                        const CUtensorMap* const* tl,
                                        int ntiles, int ntq, int H) {
  constexpr int BOX = TILE_BYTES + (D == 80 ? TAIL_BYTES : 0);
  int t0, t1;
  block_range(ntiles, t0, t1);
  auto load_tile = [&](int n, int h, int b) {
    const int li = n - t0, s = li % pl.qs;
    uint64_t* full = &sm.t_full[li & 1];
    mbar_wait(&sm.t_empty[s], ((li / pl.qs) & 1) ^ 1);
    mbar_expect_tx(full, 2 * BOX);
    const int row = (n % ntq) * TILE;
    tma_load_view(sm.slot(s, 0), m0, full, pm0, row, h, b);
    tma_load_view(sm.slot(s, 1), m1, full, pm1, row, h, b);
    if constexpr (D == 80) {
      tma_load_view(sm.slot_t(s, 0), tl[2], full, pm0, row, h, b);
      tma_load_view(sm.slot_t(s, 1), tl[3], full, pm1, row, h, b);
    }
  };
  int u = 0;
  for (int a = t0; a < t1; ++u) {
    const int bh = a / ntq, e = min(t1, (bh + 1) * ntq);
    const int b = bh / H, h = bh % H;
    int n = a;
    for (; n < min(a + pl.qs, e); ++n) load_tile(n, h, b);
    for (int c = 0; c < pl.nch; ++c) {
      mbar_wait(&sm.empty[c], (u & 1) ^ 1);
      mbar_expect_tx(&sm.full[c], 2 * BOX);
      tma_load_view(sm.chunk(0, c), r0, &sm.full[c], pr0, c * TILE, h, b);
      tma_load_view(sm.chunk(1, c), r1, &sm.full[c], pr1, c * TILE, h, b);
      if constexpr (D == 80) {
        tma_load_view(sm.chunk_t(0, c), tl[0], &sm.full[c], pr0, c * TILE, h,
                      b);
        tma_load_view(sm.chunk_t(1, c), tl[1], &sm.full[c], pr1, c * TILE, h,
                      b);
      }
    }
    for (; n < e; ++n) load_tile(n, h, b);
    a = e;
  }
}

// dq, in place: s <- exp2(s*c - x) for rows g (x0) and g + 8 (x1); keys at
// or past `valid` get 0 (accumulator element 4i + e is key 8i + 2t + e).
template <bool MASK, int N>
__device__ __forceinline__ void row_exp(float (&s)[N], int valid, int t,
                                        float c, float x0, float x1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int key = 8 * i + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !MASK || key + e < valid;
      s[4 * i + e] = ok ? fast_exp2(fmaf(s[4 * i + e], c, -x0)) : 0.f;
      s[4 * i + 2 + e] = ok ? fast_exp2(fmaf(s[4 * i + 2 + e], c, -x1)) : 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void chunk_exp(float (&s)[N], int j, int S, int t,
                                          float c, float x0, float x1) {
  const int valid = S - j * TILE;
  if (valid >= 2 * N)  // the chunk's columns all hold keys
    row_exp<false>(s, valid, t, c, x0, x1);
  else
    row_exp<true>(s, valid, t, c, x0, x1);
}

// dq, once dp has retired: s <- s * (dp - delta) (rows g, g + 8: d0, d1).
template <int N>
__device__ __forceinline__ void row_ds(float (&s)[N], const float (&dp)[N],
                                      float d0, float d1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * i + e] *= dp[4 * i + e] - d0;
      s[4 * i + 2 + e] *= dp[4 * i + 2 + e] - d1;
    }
}

// dkv, in place: s <- p^T = exp2(s*c - x) with x of the chunk's query
// columns 8i + 2t, + 1 (+inf past S, so p^T = 0 there).
template <int N>
__device__ __forceinline__ void col_exp(float (&s)[N], const float* xs,
                                        int t, float c) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float2 x = *reinterpret_cast<const float2*>(xs + 8 * i + 2 * t);
#pragma unroll
    for (int r = 0; r < 4; r += 2) {  // rows g and g + 8
      s[4 * i + r] = fast_exp2(fmaf(s[4 * i + r], c, -x.x));
      s[4 * i + r + 1] = fast_exp2(fmaf(s[4 * i + r + 1], c, -x.y));
    }
  }
}

// dkv, once dp^T has retired: dp <- p^T * (dp^T - delta), times il with
// IL (K5), with the columns' delta (and il) from `ds` (and `is`).
template <bool IL, int N>
__device__ __forceinline__ void col_ds(const float (&s)[N], float (&dp)[N],
                                      const float* ds, const float* is,
                                      int t) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float2 d = *reinterpret_cast<const float2*>(ds + 8 * i + 2 * t);
    float2 il = make_float2(1.f, 1.f);
    if (IL) il = *reinterpret_cast<const float2*>(is + 8 * i + 2 * t);
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const int x = 4 * i + r;
      dp[x] = s[x] * (dp[x] - d.x);
      dp[x + 1] = s[x + 1] * (dp[x + 1] - d.y);
      if (IL) {
        dp[x] *= il.x;
        dp[x + 1] *= il.y;
      }
    }
  }
}

// dq's narrow last chunk (at most 16 keys before S: 392 = 6*64 + 8) takes
// m64n16k16 score products, a quarter of their width, and one k-step of 16
// keys in its gradient product instead of four; keys 16..63 of the chunk
// are past S, zero-filled, and would only add zeros. (dk/dv measured no
// faster with it, and spilled: it keeps the full chunk.) At D = 80 the
// score products take the fifth k-step (xt, ut against ytd, wtd).
template <int D>
__device__ __forceinline__ void narrow_scores_start(
    float (&a)[8], float (&b)[8], const uint32_t (&xa)[4][4], uint64_t yd,
    const uint32_t (&xt)[4], uint64_t ytd, const uint32_t (&ua)[4][4],
    uint64_t wd, const uint32_t (&ut)[4], uint64_t wtd) {
  reg_fence(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n16k16_rs(a, xa[kk], yd + 2 * kk, kk);
  if constexpr (D == 80) wgmma_m64n16k16_rs(a, xt, ytd, 1);
  wgmma_commit();
  reg_fence(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n16k16_rs(b, ua[kk], wd + 2 * kk, kk);
  if constexpr (D == 80) wgmma_m64n16k16_rs(b, ut, wtd, 1);
  wgmma_commit();
}

// acc += p . x[0:16] (x MN-major: one k-step), and at D = 80 acc_t += p .
// x's lanes 64-79 (xtd), one commit group.
template <int D, int NT>
__device__ __forceinline__ void narrow_grad_start(float (&acc)[32],
                                                  float (&acc_t)[NT],
                                                  uint32_t (&p)[1][4],
                                                  uint64_t xd, uint64_t xtd) {
  reg_fence(acc);
  if constexpr (D == 80) reg_fence(acc_t);
  reg_fence(p[0]);
  wgmma_fence();
  wgmma_m64n64k16_rs_tb(acc, p[0], xd, 1);
  if constexpr (D == 80) wgmma_m64n16k16_rs_tb(acc_t, p[0], xtd, 1);
  wgmma_commit();
}

// rowsum(x * y) over this lane's part of two bf16 pairs' rows.
__device__ __forceinline__ float dot2(uint32_t x, uint32_t y) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  return fmaf(a.x, b.x, a.y * b.y);
}

// What a consumer knows of its place: the head segment u of the block and
// whether this is its last tile of the head (it then frees each chunk
// once its products are done).
struct Walk {
  int u;
  bool last;
};

// Free a ring slot once this thread's fragment loads from it are issued.
// The next TMA write into the slot is an async-proxy write after these
// generic-proxy reads: without the proxy fence a few reads (one lane's
// rows, at random, in a few tiles a launch at [64, 320, 2304]) returned
// the next tile's bytes.
__device__ __forceinline__ void release_slot(const Smem& sm, int slot) {
  fence_async_smem();
  mbar_arrive(&sm.t_empty[slot]);
}

// A consumer that has no tile of head segment u still takes part in its
// chunks' barriers: it waits for each chunk (so that it cannot arrive for a
// later head before this one is loaded) and frees it.
__device__ __forceinline__ void pass_head(const Smem& sm, int u, bool prep) {
  for (int c = 0; c < sm.nch; ++c) {
    mbar_wait(&sm.full[c], u & 1);
    if (prep) mbar_wait(&sm.prep[c], u & 1);
    mbar_arrive(&sm.empty[c]);
  }
}

// dq, once chunk j's score products have retired (N1 and N2 commit groups
// still in flight after s's and after dp's): s <- p or e, then
// s <- s * (dp - delta).
template <int N1, int N2, int N>
__device__ __forceinline__ void dq_form(float (&s)[N], float (&dp)[N], int j,
                                        int S, int t, float c, float x0,
                                        float x1, float d0, float d1) {
  wgmma_wait<N1>();
  reg_fence(s);
  chunk_exp(s, j, S, t, c, x0, x1);
  wgmma_wait<N2>();
  reg_fence(dp);
  row_ds(s, dp, d0, d1);
}

// dq's gradient sweep over the resident chunks: acc += ds.k, with
// ds = exp2(s*c - x) * (dp - delta) rounded, x and delta of rows g and
// g + 8; with NARROW the last chunk is narrow. kd, vd: the resident k and v
// K-major; kt: k MN-major; at D = 80 their lanes 64-79 (ktd, vtd, ktt),
// the tile's q and do lanes 64-79 in qt, dot, and dq's in acc_t.
template <bool NARROW, int D, int NT>
__device__ __forceinline__ void dq_sweep(float (&acc)[32], float (&acc_t)[NT],
                                         const uint32_t (&qa)[4][4],
                                         const uint32_t (&qt)[4],
                                         const uint32_t (&doa)[4][4],
                                         const uint32_t (&dot)[4],
                                         const Smem& sm, const Walk& w,
                                         int S, int t, float c, float x0,
                                         float x1, float d0, float d1) {
  const uint64_t kd = kmajor(sm.chunk(0, 0)), vd = kmajor(sm.chunk(1, 0));
  const uint64_t kt = mnmajor(sm.chunk(0, 0));
  uint64_t ktd = 0, vtd = 0, ktt = 0;
  if constexpr (D == 80) {
    ktd = kmajor_t(sm.chunk_t(0, 0));
    vtd = kmajor_t(sm.chunk_t(1, 0));
    ktt = mnmajor_t(sm.chunk_t(0, 0));
  }
  const int nch = sm.nch, par = w.u & 1;
  const int nfull = NARROW ? nch - 1 : nch;  // full chunks
  float s[32], dp[32];
  uint32_t ds[4][4];
  if (!NARROW || nfull > 0) {
    mbar_wait(&sm.full[0], par);
    scores_start<D>(s, dp, qa, kd, qt, ktd, doa, vd, dot, vtd);
    dq_form<1, 0>(s, dp, 0, S, t, c, x0, x1, d0, d1);
    pack_pairs(s, ds);
  }
  for (int j = 0; j + 1 < nfull; ++j) {
    mbar_wait(&sm.full[j + 1], par);
    scores_start<D>(s, dp, qa, kd + (j + 1) * TILE_UNITS, qt,
                    ktd + (j + 1) * TAIL_UNITS, doa,
                    vd + (j + 1) * TILE_UNITS, dot,
                    vtd + (j + 1) * TAIL_UNITS);
    grad_start<D>(acc, acc_t, ds, kt + j * TILE_UNITS, ktt + j * TAIL_UNITS);
    // products retire in order: s, then dp, then the gradient
    dq_form<2, 1>(s, dp, j + 1, S, t, c, x0, x1, d0, d1);
    wgmma_wait<0>();
    acc_fence<D>(acc, acc_t);
    if (w.last) mbar_arrive(&sm.empty[j]);
    pack_pairs(s, ds);
  }
  if (NARROW) {
    const int jn = nch - 1;
    float sn[8], dpn[8];
    uint32_t dsn[1][4];
    mbar_wait(&sm.full[jn], par);
    narrow_scores_start<D>(sn, dpn, qa, kd + jn * TILE_UNITS, qt,
                           ktd + jn * TAIL_UNITS, doa, vd + jn * TILE_UNITS,
                           dot, vtd + jn * TAIL_UNITS);
    if (nfull > 0) {
      grad_start<D>(acc, acc_t, ds, kt + (jn - 1) * TILE_UNITS,
                    ktt + (jn - 1) * TAIL_UNITS);
      dq_form<2, 1>(sn, dpn, jn, S, t, c, x0, x1, d0, d1);
      wgmma_wait<0>();
      acc_fence<D>(acc, acc_t);
      if (w.last) mbar_arrive(&sm.empty[jn - 1]);
    } else {
      dq_form<1, 0>(sn, dpn, jn, S, t, c, x0, x1, d0, d1);
    }
    pack_pairs(sn, dsn);
    narrow_grad_start<D>(acc, acc_t, dsn, kt + jn * TILE_UNITS,
                         ktt + jn * TAIL_UNITS);
  } else {
    grad_start<D>(acc, acc_t, ds, kt + (nch - 1) * TILE_UNITS,
                  ktt + (nch - 1) * TAIL_UNITS);
  }
  wgmma_wait<0>();
  acc_fence<D>(acc, acc_t);
  if (w.last) mbar_arrive(&sm.empty[nch - 1]);
}

// Add rowsum(s * dp) over this lane's columns to rows g (p0) and g + 8
// (p1), two partial sums a row.
template <int N>
__device__ __forceinline__ void row_dot(const float (&s)[N],
                                        const float (&dp)[N], float (&p0)[2],
                                        float (&p1)[2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    p0[i & 1] += s[4 * i] * dp[4 * i] + s[4 * i + 1] * dp[4 * i + 1];
    p1[i & 1] += s[4 * i + 2] * dp[4 * i + 2] + s[4 * i + 3] * dp[4 * i + 3];
  }
}

// K5's first dq sweep: rowsum(e * dp) over the resident chunks, this
// lane's part of rows g (d0) and g + 8 (d1); with NARROW the last chunk is
// narrow. At D = 80 the score products take the fifth k-step (the tile's
// lanes 64-79 qt and dot against the chunks' ktd, vtd).
template <bool NARROW, int D>
__device__ __forceinline__ void delta_sweep(const uint32_t (&qa)[4][4],
                                            const uint32_t (&qt)[4],
                                            const uint32_t (&doa)[4][4],
                                            const uint32_t (&dot)[4],
                                            const Smem& sm, const Walk& w,
                                            int S, int t, float c, float x0,
                                            float x1, float& d0, float& d1) {
  const uint64_t kd = kmajor(sm.chunk(0, 0)), vd = kmajor(sm.chunk(1, 0));
  uint64_t ktd = 0, vtd = 0;
  if constexpr (D == 80) {
    ktd = kmajor_t(sm.chunk_t(0, 0));
    vtd = kmajor_t(sm.chunk_t(1, 0));
  }
  const int nfull = NARROW ? sm.nch - 1 : sm.nch;
  float p0[2] = {0.f, 0.f}, p1[2] = {0.f, 0.f};
  for (int j = 0; j < nfull; ++j) {
    float s[32], dp[32];
    mbar_wait(&sm.full[j], w.u & 1);
    scores_start<D>(s, dp, qa, kd + j * TILE_UNITS, qt, ktd + j * TAIL_UNITS,
                    doa, vd + j * TILE_UNITS, dot, vtd + j * TAIL_UNITS);
    wgmma_wait<1>();
    reg_fence(s);
    chunk_exp(s, j, S, t, c, x0, x1);
    wgmma_wait<0>();
    reg_fence(dp);
    row_dot(s, dp, p0, p1);
  }
  if (NARROW) {
    const int jn = sm.nch - 1;
    float s[8], dp[8];
    mbar_wait(&sm.full[jn], w.u & 1);
    narrow_scores_start<D>(s, dp, qa, kd + jn * TILE_UNITS, qt,
                           ktd + jn * TAIL_UNITS, doa, vd + jn * TILE_UNITS,
                           dot, vtd + jn * TAIL_UNITS);
    wgmma_wait<1>();
    reg_fence(s);
    chunk_exp(s, jn, S, t, c, x0, x1);
    wgmma_wait<0>();
    reg_fence(dp);
    row_dot(s, dp, p0, p1);
  }
  d0 = quad_sum(p0[0] + p0[1]);
  d1 = quad_sum(p1[0] + p1[1]);
}

// st0, st1: K2 lse2 and null; K5 m and l. o: K2's forward output (delta).
// NARROW: the last chunk holds at most 16 rows before S.
template <bool GROUPED, bool NARROW, int D>
__global__ void __launch_bounds__(THREADS, 1)
    short_attn_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ TailMaps<D> tails,
                               View o, const float* __restrict__ st0,
                               const float* __restrict__ st1,
                               float* __restrict__ delta, View dq, int S,
                               int H, int ntiles, float c, float scale,
                               int perms, Plan pl) {
  constexpr int NT = tail_regs<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw, pl);
  const int ntq = pl.nch;  // tiles a head (a kernel parameter, no register)
  const int wg = threadIdx.x >> 7;
  init_barriers(sm, pl, false);

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      tma_prefetch(&do_map);
      // lanes 64-79 (D = 80): resident k, v, then the tiles' q, do
      const CUtensorMap* tl[4] = {nullptr, nullptr, nullptr, nullptr};
      if constexpr (D == 80) {
        tl[0] = &tails.k;
        tl[1] = &tails.v;
        tl[2] = &tails.q;
        tl[3] = &tails.dout;
      }
      produce<D>(sm, pl, &k_map, (perms >> 6) & 63, &v_map,
                 (perms >> 12) & 63, &q_map, perms & 63, &do_map,
                 (perms >> 18) & 63, tl, ntiles, ntq, H);
    }
    return;
  }
  // -------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = (threadIdx.x >> 5) & 3;
  int t0, t1;
  block_range(ntiles, t0, t1);
  Walk walk{0, false};
  for (int a = t0; a < t1; ++walk.u) {
    const int bh = a / ntq, e = min(t1, (bh + 1) * ntq);
    const int b = bh / H, h = bh % H;
    const size_t stat = (size_t)bh * S;
    int n = a + ((wg ^ (a - t0)) & 1);
    if (n >= e) pass_head(sm, walk.u, false);
    for (; n < e; n += 2) {
      walk.last = n + 2 >= e;
      const int li = n - t0, slot = li % pl.qs;
      const int row = (n - bh * ntq) * TILE + 16 * w + g;  // and row + 8
      const bool ok0 = row < S, ok1 = row + 8 < S;
      // K2: o at this lane's places of do's fragments (kk = 4: lanes 64-79
      // at D = 80)
      uint32_t ov[D / 16][4];
      if (!GROUPED) {
        const bf16* o0 = o.head(b, h) + (size_t)row * o.sr + 2 * t;
        const bf16* o1 = o0 + 8 * o.sr;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ov[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(o0 + 16 * kk) : 0u;
          ov[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(o1 + 16 * kk) : 0u;
          ov[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(o0 + 16 * kk + 8) : 0u;
          ov[kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(o1 + 16 * kk + 8) : 0u;
        }
      }
      const float a0 = ok0 ? st0[stat + row] : 0.f;
      const float a1 = ok1 ? st0[stat + row + 8] : 0.f;
      float il0 = 0.f, il1 = 0.f;
      if (GROUPED) {
        il0 = ok0 ? 1.f / st1[stat + row] : 0.f;
        il1 = ok1 ? 1.f / st1[stat + row + 8] : 0.f;
      }
      uint32_t qa[4][4], doa[4][4], qt[4], dot[4];
      mbar_wait(&sm.t_full[wg], (li >> 1) & 1);
      load_frags(qa, sm.slot(slot, 0), w, g, t);
      load_frags(doa, sm.slot(slot, 1), w, g, t);
      if constexpr (D == 80) {
        load_tail_frag(qt, sm.slot_t(slot, 0), w, g, t);
        load_tail_frag(dot, sm.slot_t(slot, 1), w, g, t);
      }
      release_slot(sm, slot);

      // the row statistic x of exp2(s*c - x), and delta
      const float x0 = GROUPED ? a0 * c : a0, x1 = GROUPED ? a1 * c : a1;
      float d0 = 0.f, d1 = 0.f;
      if (GROUPED) {
        delta_sweep<NARROW, D>(qa, qt, doa, dot, sm, walk, S, t, c, x0, x1,
                               d0, d1);
        d0 *= il0;
        d1 *= il1;
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          d0 += dot2(doa[kk][0], ov[kk][0]) + dot2(doa[kk][2], ov[kk][2]);
          d1 += dot2(doa[kk][1], ov[kk][1]) + dot2(doa[kk][3], ov[kk][3]);
        }
        if constexpr (D == 80) {
          d0 += dot2(dot[0], ov[4][0]) + dot2(dot[2], ov[4][2]);
          d1 += dot2(dot[1], ov[4][1]) + dot2(dot[3], ov[4][3]);
        }
        d0 = quad_sum(d0);
        d1 = quad_sum(d1);
      }
      if (t == 0) {
        if (ok0) delta[stat + row] = d0;
        if (ok1) delta[stat + row + 8] = d1;
      }
      float acc[32], acc_t[NT];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) acc_t[i] = 0.f;
      dq_sweep<NARROW, D>(acc, acc_t, qa, qt, doa, dot, sm, walk, S, t, c, x0,
                          x1, d0, d1);
      store_rows<D>(dq.head(b, h), dq.sr, acc, acc_t, row, S, t,
                    GROUPED ? scale * il0 : scale,
                    GROUPED ? scale * il1 : scale);
    }
    a = e;
  }
}

// dkv, once chunk j's score products have retired (N1 and N2 commit
// groups still in flight after s^T's and after dp^T's): s <- p^T or e,
// then dp <- ds^T, from the chunk's column statistics.
template <int N1, int N2, bool GROUPED, int N>
__device__ __forceinline__ void dkv_form(float (&s)[N], float (&dp)[N],
                                         const Smem& sm, int j, int t,
                                         float c) {
  wgmma_wait<N1>();
  reg_fence(s);
  col_exp(s, sm.stat(0, j), t, c);
  wgmma_wait<N2>();
  reg_fence(dp);
  col_ds<GROUPED>(s, dp, sm.stat(1, j), sm.stat(2, j), t);
}

// K5's dkv at D = 80: bf16(do * il) of resident chunk j into a consumer's
// own tile, at the places do has it (the swizzles move whole 16 bytes
// within a row), by one prep warp: each lane takes 16 bytes a pass, 16
// passes of lanes 0-63 and 4 of lanes 64-79, with il of the chunk's rows
// (0 past S).
__device__ __forceinline__ void own_do_il(const Smem& sm, int j, int w,
                                          int lane) {
  const float* il = sm.stat(2, j);
#pragma unroll 2
  for (int pass = 0; pass < 20; ++pass) {
    const int x = pass * 32 + lane;
    const bool tail = pass >= 16;
    const int r = tail ? (x - 512) >> 1 : x >> 3;
    const int off = tail ? r * 32 + ((x & 1) << 4) : r * 128 + ((x & 7) << 4);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(
        tail ? sm.chunk_t(1, j) : sm.chunk(1, j)) + off;
    uint8_t* dst = reinterpret_cast<uint8_t*>(
        tail ? sm.own_tile_t(w) : sm.own_tile(w)) + off;
    const float f = il[r];
    uint4 v = *reinterpret_cast<const uint4*>(src);
    uint32_t* x4 = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 e = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x4[k]));
      x4[k] = bf2(e.x * f, e.y * f);
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// The prep warps of dkv: for each head of the block's range and each
// resident chunk, once it has landed, the chunk's column statistics (K2:
// lse2 and delta; K5: m*c, il = 1/l and delta; queries past S +inf, 0, 0)
// and, for K5 at D = 64, bf16(do * il) beside do. One thread a query row r.
// For K5 at D = 80 each prep warp then serves one consumer: for each of
// that consumer's tiles of the head (the consumers' own order) and each
// chunk, once every row's il is in and the consumer's products have read
// its own tile, bf16(do * il) of the chunk into that tile.
template <bool GROUPED, int D>
__device__ __forceinline__ void prep(const Smem& sm, int r,
                                     const float* st0, const float* st1,
                                     const float* delta, int S, int H,
                                     int ntiles, int ntq, float c) {
  int t0, t1;
  block_range(ntiles, t0, t1);
  int u = 0, uses = 0;
  for (int a = t0; a < t1; ++u) {
    const int bh = a / ntq, e = min(t1, (bh + 1) * ntq);
    const size_t stat = (size_t)bh * S;
    for (int ch = 0; ch < sm.nch; ++ch) {
      const int row = ch * TILE + r;
      const bool ok = row < S;
      const float x = ok ? st0[stat + row] : 0.f;
      const float dl = ok ? delta[stat + row] : 0.f;
      const float il = GROUPED && ok ? 1.f / st1[stat + row] : 0.f;
      mbar_wait(&sm.full[ch], u & 1);
      sm.stat(0, ch)[r] = ok ? (GROUPED ? x * c : x) : INFINITY;
      sm.stat(1, ch)[r] = dl;
      if (GROUPED) sm.stat(2, ch)[r] = il;
      if (GROUPED && D == 64) {
        // do's row r, 16 bytes at a time, times il into the third
        // resident tensor at the same places (the swizzle moves whole 16
        // bytes within a row); rotated so a warp's 8-thread phases hit 8
        // distinct bank groups
        const uint8_t* src =
            reinterpret_cast<const uint8_t*>(sm.chunk(1, ch)) + r * 128;
        uint8_t* dst = reinterpret_cast<uint8_t*>(sm.chunk(2, ch)) + r * 128;
#pragma unroll 2
        for (int p = 0; p < 8; ++p) {
          const int off = ((p + r) & 7) * 16;
          uint4 v = *reinterpret_cast<const uint4*>(src + off);
          uint32_t* x4 = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&x4[k]));
            x4[k] = bf2(f.x * il, f.y * il);
          }
          *reinterpret_cast<uint4*>(dst + off) = v;
        }
        fence_async_smem();
      }
      mbar_arrive(&sm.prep[ch]);
    }
    if constexpr (GROUPED && D == 80) {
      const int w = r >> 5;
      for (int n = a + ((w ^ (a - t0)) & 1); n < e; n += 2)
        for (int j = 0; j < sm.nch; ++j, ++uses) {
          mbar_wait(&sm.prep[j], u & 1);
          mbar_wait(&sm.own_empty[w], (uses & 1) ^ 1);
          own_do_il(sm, j, w, r & 31);
          fence_async_smem();
          mbar_arrive(&sm.own_full[w]);
        }
    }
    a = e;
  }
}

// st0, st1: K2 lse2 and null; K5 m and l. delta: from the dq kernel.
template <bool GROUPED, int D>
__global__ void __launch_bounds__(THREADS, 1)
    short_attn_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const __grid_constant__ TailMaps<D> tails,
                                const float* __restrict__ st0,
                                const float* __restrict__ st1,
                                const float* __restrict__ delta, View dk,
                                View dv, int S, int H, int ntiles, float c,
                                float scale, int perms, Plan pl) {
  constexpr int NT = tail_regs<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw, pl);
  const int ntq = pl.nch;  // tiles a head (a kernel parameter, no register)
  const int wg = threadIdx.x >> 7;
  init_barriers(sm, pl, true);

  if (wg == 2) {
    // ------------------------------------- producer thread, prep warps
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      tma_prefetch(&do_map);
      // lanes 64-79 (D = 80): resident q, do, then the tiles' k, v
      const CUtensorMap* tl[4] = {nullptr, nullptr, nullptr, nullptr};
      if constexpr (D == 80) {
        tl[0] = &tails.q;
        tl[1] = &tails.dout;
        tl[2] = &tails.k;
        tl[3] = &tails.v;
      }
      produce<D>(sm, pl, &q_map, perms & 63, &do_map, (perms >> 18) & 63,
                 &k_map, (perms >> 6) & 63, &v_map, (perms >> 12) & 63, tl,
                 ntiles, ntq, H);
    } else if (threadIdx.x >= CONSUMERS + 32 &&
               threadIdx.x < CONSUMERS + 32 + PREP) {
      prep<GROUPED, D>(sm, threadIdx.x - CONSUMERS - 32, st0, st1, delta, S,
                       H, ntiles, ntq, c);
    }
    return;
  }
  // -------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = (threadIdx.x >> 5) & 3;
  int t0, t1;
  block_range(ntiles, t0, t1);
  int u = 0, uses = 0;  // uses: of this consumer's own tile (K5, D = 80)
  for (int a = t0; a < t1; ++u) {
    const int bh = a / ntq, e = min(t1, (bh + 1) * ntq);
    const int b = bh / H, h = bh % H;
    int n = a + ((wg ^ (a - t0)) & 1);
    if (n >= e) pass_head(sm, u, true);
    for (; n < e; n += 2) {
      const int li = n - t0, slot = li % pl.qs;
      const int row = (n - bh * ntq) * TILE + 16 * w + g;  // and row + 8
      uint32_t ka[4][4], va[4][4], kt[4], vt4[4];
      mbar_wait(&sm.t_full[wg], (li >> 1) & 1);
      load_frags(ka, sm.slot(slot, 0), w, g, t);
      load_frags(va, sm.slot(slot, 1), w, g, t);
      if constexpr (D == 80) {
        load_tail_frag(kt, sm.slot_t(slot, 0), w, g, t);
        load_tail_frag(vt4, sm.slot_t(slot, 1), w, g, t);
      }
      release_slot(sm, slot);
      float dk_acc[32], dv_acc[32], dk_t[NT], dv_t[NT];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) dk_t[i] = dv_t[i] = 0.f;
      const bool last = n + 2 >= e;
      const int par = u & 1;
      // the resident q and do K-major, q MN-major, and dv's right operand:
      // do (K2) or bf16(do * il) (K5: resident at D = 64, the consumer's
      // own tile at 80), MN-major
      const uint64_t qd = kmajor(sm.chunk(0, 0)), dod = kmajor(sm.chunk(1, 0));
      const uint64_t qt = mnmajor(sm.chunk(0, 0));
      const uint64_t vt = mnmajor(sm.chunk(GROUPED && D == 64 ? 2 : 1, 0));
      // D = 80: lanes 64-79 of the resident q and do, K-major and MN-major
      uint64_t qtd = 0, dotd = 0, qtt = 0, dott = 0;
      if constexpr (D == 80) {
        qtd = kmajor_t(sm.chunk_t(0, 0));
        dotd = kmajor_t(sm.chunk_t(1, 0));
        qtt = mnmajor_t(sm.chunk_t(0, 0));
        dott = mnmajor_t(sm.chunk_t(1, 0));
      }
      float s[32], dp[32];
      uint32_t pa[4][4], dsa[4][4];
      auto ready = [&](int j) {
        mbar_wait(&sm.full[j], par);
        mbar_wait(&sm.prep[j], par);
      };
      const int nch = sm.nch;
      if constexpr (D == 80) {
        // one chunk at a time: chunk j + 1's score products do not run
        // under chunk j's gradient products, so s, dp and their packed
        // copies are never live at once beside the 80-lane accumulators
        // and fragments (232 registers do not hold them all). K5's dv
        // reads bf16(do * il) from this consumer's own tile, which its prep
        // warp writes while the chunk's score products run.
        const uint64_t own = mnmajor(sm.own_tile(wg));
        const uint64_t own_t = mnmajor_t(sm.own_tile_t(wg));
        for (int j = 0; j < nch; ++j) {
          ready(j);
          scores_start<D>(s, dp, ka, qd + j * TILE_UNITS, kt,
                          qtd + j * TAIL_UNITS, va, dod + j * TILE_UNITS, vt4,
                          dotd + j * TAIL_UNITS);
          dkv_form<1, 0, GROUPED>(s, dp, sm, j, t, c);
          pack_pairs(s, pa);
          pack_pairs(dp, dsa);
          if (GROUPED) mbar_wait(&sm.own_full[wg], uses & 1);
          grads_start<D>(dv_acc, dv_t, pa, GROUPED ? own : vt + j * TILE_UNITS,
                         GROUPED ? own_t : dott + j * TAIL_UNITS, dk_acc, dk_t,
                         dsa, qt + j * TILE_UNITS, qtt + j * TAIL_UNITS);
          wgmma_wait<0>();
          acc_fence<D>(dv_acc, dv_t);
          acc_fence<D>(dk_acc, dk_t);
          if (GROUPED) {
            mbar_arrive(&sm.own_empty[wg]);
            ++uses;
          }
          if (last) mbar_arrive(&sm.empty[j]);
        }
        store_rows<D>(dk.head(b, h), dk.sr, dk_acc, dk_t, row, S, t, scale,
                      scale);
        store_rows<D>(dv.head(b, h), dv.sr, dv_acc, dv_t, row, S, t, 1.f,
                      1.f);
        continue;
      }
      ready(0);
      scores_start<D>(s, dp, ka, qd, kt, qtd, va, dod, vt4, dotd);
      dkv_form<1, 0, GROUPED>(s, dp, sm, 0, t, c);
      pack_pairs(s, pa);
      pack_pairs(dp, dsa);
      for (int j = 0; j + 1 < nch; ++j) {
        ready(j + 1);
        scores_start<D>(s, dp, ka, qd + (j + 1) * TILE_UNITS, kt,
                        qtd + (j + 1) * TAIL_UNITS, va,
                        dod + (j + 1) * TILE_UNITS, vt4,
                        dotd + (j + 1) * TAIL_UNITS);
        grads_start<D>(dv_acc, dv_t, pa, vt + j * TILE_UNITS,
                       dott + j * TAIL_UNITS, dk_acc, dk_t, dsa,
                       qt + j * TILE_UNITS, qtt + j * TAIL_UNITS);
        // products retire in order: s^T, then dp^T, then the gradients
        dkv_form<2, 1, GROUPED>(s, dp, sm, j + 1, t, c);
        wgmma_wait<0>();
        acc_fence<D>(dv_acc, dv_t);
        acc_fence<D>(dk_acc, dk_t);
        if (last) mbar_arrive(&sm.empty[j]);
        pack_pairs(s, pa);
        pack_pairs(dp, dsa);
      }
      grads_start<D>(dv_acc, dv_t, pa, vt + (nch - 1) * TILE_UNITS,
                     dott + (nch - 1) * TAIL_UNITS, dk_acc, dk_t, dsa,
                     qt + (nch - 1) * TILE_UNITS, qtt + (nch - 1) * TAIL_UNITS);
      wgmma_wait<0>();
      acc_fence<D>(dv_acc, dv_t);
      acc_fence<D>(dk_acc, dk_t);
      if (last) mbar_arrive(&sm.empty[nch - 1]);
      store_rows<D>(dk.head(b, h), dk.sr, dk_acc, dk_t, row, S, t, scale,
                    scale);
      store_rows<D>(dv.head(b, h), dv.sr, dv_acc, dv_t, row, S, t, 1.f, 1.f);
    }
    a = e;
  }
}

// The plan of a kernel at S keys: two ring slots where they fit, else one;
// nch = 0 where not even that fits. K5's dkv keeps bf16(do * il) resident
// at D = 64 and forms it in a tile of each consumer's own at 80.
template <int D>
Plan plan_for(bool dkv, bool grouped, int S) {
  const bool own = dkv && grouped && D == 80;
  Plan p{(S + TILE - 1) / TILE, dkv && grouped && !own ? 3 : 2,
         dkv ? (grouped ? 3 : 2) : 0, 2, own ? 1 : 0};
  if (p.bytes<D>() > SMEM_MAX) p.qs = 1;
  if (p.bytes<D>() > SMEM_MAX) p.nch = 0;
  return p;
}

// The maps of q, k, v and do (views 0..3 of `ptrs`, strides[3i..3i+2]) in
// 64-row boxes, and at D = 80 their lanes-64-79 maps; *perms packs their
// orders, 6 bits each.
template <int D>
int encode_maps(CUtensorMap (&maps)[4], TailMaps<D>& tails, int* perms,
                const void* const* ptrs, const long long* strides, int B,
                int H, int S, const char* who) {
  CUtensorMap tmaps[4];
  *perms = 0;
  for (int i = 0; i < 4; ++i) {
    int perm = 0;
    const int err = encode_view_d(&maps[i], &tmaps[i], D, ptrs[i],
                                  strides + 3 * i, B, H, S, TILE, &perm, who);
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

// The launch of one kernel instantiation: it may take all of shared
// memory (set once), one block an SM, each with at least two tiles where
// there are fewer.
template <int D, typename K, typename... Args>
int launch(K kernel, bool& allowed, const Plan& pl, int ntiles,
           cudaStream_t stream, Args... args) {
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int want = (ntiles + 1) / 2;
  const int grid = want < sm_count() ? want : sm_count();
  kernel<<<grid, THREADS, pl.bytes<D>(), stream>>>(args...);
  return (int)cudaGetLastError();
}

// Whether the last chunk of S rows takes the narrow products.
bool narrow(int S) { return S % TILE != 0 && S % TILE <= 16; }

template <bool GROUPED, bool NARROW, int D>
int launch_dq(const CUtensorMap (&m)[4], const TailMaps<D>& tails,
              const void* const* views, const long long* strides,
              const float* st0, const float* st1, float* delta, int S, int H,
              int ntiles, float c, float scale, int perms, const Plan& pl,
              cudaStream_t stream) {
  static bool allowed = false;
  return launch<D>(short_attn_dq_wgmma_kernel<GROUPED, NARROW, D>, allowed,
                   pl, ntiles, stream, m[0], m[1], m[2], m[3], tails,
                   view_of(views[4], strides, 4), st0, st1, delta,
                   view_of(views[5], strides, 5), S, H, ntiles, c, scale,
                   perms, pl);
}

template <bool GROUPED, int D>
int launch_dkv(const CUtensorMap (&m)[4], const TailMaps<D>& tails,
               const void* const* views, const long long* strides,
               const float* st0, const float* st1, const float* delta, int S,
               int H, int ntiles, float c, float scale, int perms,
               const Plan& pl, cudaStream_t stream) {
  static bool allowed = false;
  return launch<D>(short_attn_dkv_wgmma_kernel<GROUPED, D>, allowed, pl,
                   ntiles, stream, m[0], m[1], m[2], m[3], tails, st0, st1,
                   delta, view_of(views[4], strides, 4),
                   view_of(views[5], strides, 5), S, H, ntiles, c, scale,
                   perms, pl);
}

// views: q, k, v, do (the maps' order), then o (K2; unused by K5) and dq.
template <bool GROUPED, int D>
int run_dq(const void* const* views, const long long* strides,
           const float* st0, const float* st1, float* delta, int B, int S,
           int H, float c, float scale, cudaStream_t stream,
           const char* who) {
  const Plan pl = plan_for<D>(false, GROUPED, S);
  if (S < 1 || S > max_seq<D>() || B < 1 || H < 1 || pl.nch == 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  TailMaps<D> tails;
  int perms = 0;
  const int err = encode_maps<D>(maps, tails, &perms, views, strides, B, H,
                                 S, who);
  if (err != 0) return err;
  const int ntiles = B * H * pl.nch;
  return narrow(S)
             ? launch_dq<GROUPED, true, D>(maps, tails, views, strides, st0,
                                           st1, delta, S, H, ntiles, c, scale,
                                           perms, pl, stream)
             : launch_dq<GROUPED, false, D>(maps, tails, views, strides, st0,
                                            st1, delta, S, H, ntiles, c,
                                            scale, perms, pl, stream);
}

// views: q, k, v, do, then dk and dv.
template <bool GROUPED, int D>
int run_dkv(const void* const* views, const long long* strides,
            const float* st0, const float* st1, const float* delta, int B,
            int S, int H, float c, float scale, cudaStream_t stream,
            const char* who) {
  const Plan pl = plan_for<D>(true, GROUPED, S);
  if (S < 1 || S > max_seq<D>() || B < 1 || H < 1 || pl.nch == 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  TailMaps<D> tails;
  int perms = 0;
  const int err = encode_maps<D>(maps, tails, &perms, views, strides, B, H,
                                 S, who);
  if (err != 0) return err;
  const int ntiles = B * H * pl.nch;
  return launch_dkv<GROUPED, D>(maps, tails, views, strides, st0, st1, delta,
                                S, H, ntiles, c, scale, perms, pl, stream);
}

// K2 at head dim D: dq, then dk/dv (views as unite_short_qkv_bwd takes
// them).
template <int D>
int run_qkv_bwd(const void* const* all, const long long* strides,
                const float* lse, float* delta, int B, int S, int H, float c,
                float scale, cudaStream_t s) {
  static const int perm_dq[6] = {0, 1, 2, 4, 3, 5};
  static const int perm_dkv[6] = {0, 1, 2, 4, 6, 7};
  long long st[18];
  const void* views[6];
  for (int i = 0; i < 6; ++i) {
    views[i] = all[perm_dq[i]];
    for (int j = 0; j < 3; ++j) st[3 * i + j] = strides[3 * perm_dq[i] + j];
  }
  int err = run_dq<false, D>(views, st, lse, nullptr, delta, B, S, H, c,
                             scale, s, "unite_short_qkv_bwd");
  if (err != 0) return err;
  for (int i = 0; i < 6; ++i) {
    views[i] = all[perm_dkv[i]];
    for (int j = 0; j < 3; ++j) st[3 * i + j] = strides[3 * perm_dkv[i] + j];
  }
  return run_dkv<false, D>(views, st, lse, nullptr, delta, B, S, H, c, scale,
                           s, "unite_short_qkv_bwd");
}

}  // namespace

// K2: q, k, v, o, do, dq, dk, dv, each a [B, H, S, D] bf16 view (in
// practice the lane slices of qkv, out, do and dqkv) whose (batch, head,
// row) strides in elements are strides[3i..3i+2] in that order; lse (K1's
// lse2, in) and delta (out, then in) [B, H, S] fp32 contiguous. c =
// scale*log2(e); D = 64 with 1 <= S <= 768, or D = 80 with 1 <= S <= 512
// (cudaErrorInvalidValue otherwise). q, k, v and do need 16-byte aligned
// bases and strides that are multiples of 8 elements (for a dimension of
// extent > 1). Launches the dq kernel, then the dk/dv kernel, on
// `stream`; returns a CUDA error code (the first launch's, or a tensor
// map's).
extern "C" int unite_short_qkv_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, const void* lse, void* delta,
                                   const long long* strides, int B, int S,
                                   int H, int D, float c, float scale,
                                   void* stream) {
  const void* all[8] = {q, k, v, o, dout, dq, dk, dv};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return run_qkv_bwd<64>(all, strides, l, dl, B, S, H, c, scale, s);
  if (D == 80)
    return run_qkv_bwd<80>(all, strides, l, dl, B, S, H, c, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K5's dq and delta: q, k, v, do, dq [B, H, S, D] bf16 views with
// strides[3i..3i+2] in that order; m and l (in, from
// unite_short_grouped_fwd) and delta (out) [B, H, S] fp32 contiguous;
// D = 64 with 1 <= S <= 768 (a head's k and v take 192 KB of shared memory
// there), or D = 80 with 1 <= S <= 512 (160 KB); cudaErrorInvalidValue
// otherwise. The view rules of unite_short_qkv_bwd.
extern "C" int unite_short_grouped_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* m, const void* l,
                                      void* delta, void* dq,
                                      const long long* strides, int B, int S,
                                      int H, int D, float c, float scale,
                                      void* stream) {
  long long st[18];
  for (int i = 0; i < 12; ++i) st[i] = strides[i];
  for (int j = 0; j < 3; ++j) st[12 + j] = st[15 + j] = strides[12 + j];
  const void* views[6] = {q, k, v, dout, dq, dq};  // no o: dq in its place
  const float* mx = static_cast<const float*>(m);
  const float* sum = static_cast<const float*>(l);
  float* dl = static_cast<float*>(delta);
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return run_dq<true, 64>(views, st, mx, sum, dl, B, S, H, c, scale, s,
                            "unite_short_grouped_dq");
  if (D == 80)
    return run_dq<true, 80>(views, st, mx, sum, dl, B, S, H, c, scale, s,
                            "unite_short_grouped_dq");
  return (int)cudaErrorInvalidValue;
}

// K5's dk and dv from q, k, v, do, m, l and the dq kernel's delta: views
// q, k, v, do, dk, dv with strides[3i..3i+2] in that order; 1 <= S <= 512
// at either head dim (cudaErrorInvalidValue otherwise): at D = 64 q, do
// and bf16(do * il) of a head take 192 KB of shared memory there, at
// D = 80 q and do take 160 KB and each consumer's own tile of bf16(do * il)
// 20 KB.
extern "C" int unite_short_grouped_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* m, const void* l,
                                       const void* delta, void* dk, void* dv,
                                       const long long* strides, int B,
                                       int S, int H, int D, float c,
                                       float scale, void* stream) {
  const void* views[6] = {q, k, v, dout, dk, dv};
  const float* mx = static_cast<const float*>(m);
  const float* sum = static_cast<const float*>(l);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return run_dkv<true, 64>(views, strides, mx, sum, dl, B, S, H, c, scale,
                             s, "unite_short_grouped_dkv");
  if (D == 80)
    return run_dkv<true, 80>(views, strides, mx, sum, dl, B, S, H, c, scale,
                             s, "unite_short_grouped_dkv");
  return (int)cudaErrorInvalidValue;
}
