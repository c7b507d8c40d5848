// Flash attention forward for Hopper (sm_90a) over strided [B, H, S, 64]
// bf16 views, any sequence length, on wgmma with TMA loads and a producer
// warp. One kernel body serves two TPU kernels:
//
//   K3 replaces unite_tpu/ops/attention.py::_packed_fwd_kernel (called from
//      _packed_flash_fwd): q, k, v are lane slices of the packed qkv
//      [B, S, 3*H*64] and o is written into [B, S, H*64], with strides;
//   K6 replaces unite_tpu/ops/attention.py::_fwd_kernel (called from
//      _flash_fwd): q, k, v and o are [B, H, S, 64] tensors, contiguous or
//      strided views of the qkv projection's output (1569 = 1568 patches +
//      CLS, 577, 785).
//
// Per head: o = softmax(q.k^T * scale) . v, and the base-2 row log-sum-exp
// lse2 = m*c + log2(l), [B, H, S] fp32, when the caller trains. The
// function is the TPU kernels': bf16 operands, fp32 accumulation, c =
// scale*log2(e) folded into exp2, p = exp2((s - m)*c) rounded to bf16
// against the EXACT row max m over all S keys, l = the row sum of the
// rounded p, o = (p.v) * (1/l) in bf16. An online-softmax rescale would
// round p against a running max, a different function, so the keys are
// swept twice: sweep 1 takes the row max of q.k^T, sweep 2 recomputes
// q.k^T, forms p and l, and accumulates p.v. That is 6*S^2*64 flops a head
// against the attention's 4*S^2*64.
//
// What bounds it on the H100: at the stage-2 eval shape [32, 1568, 2304]
// the attention is 2.42e11 flops (0.244 ms at 989 TFLOP/s), 3.63e11 with
// the exact-max sweep, against 0.31 GB of q, k, v read and o written (0.09
// ms at 3.35 TB/s): operations bound it, and only wgmma reaches the tensor
// cores' rate. The earlier kernel (mma.sync through ldmatrix, a cp.async
// ring with a block barrier on every 64-key tile) ran at 23% of that peak.
//
// Design. A block takes one (128-query tile, head, batch) with three
// warpgroups:
// * warpgroups 0 and 1 consume, 64 query rows each, with setmaxnreg
//   raised: q.k^T is wgmma m64n128k16 with q and k both K-major in shared
//   memory; the row max and the softmax run on the fp32 accumulator in
//   registers (a quad of lanes shares a row); the m64n128 accumulator,
//   rounded to bf16, is already the A fragment of the p.v product, which is
//   wgmma m64n64k16 with A from registers and v MN-major (transpose bit);
// * warpgroup 2 produces, with setmaxnreg lowered: one thread starts TMA
//   loads of the q tile (once) and of 128-key tiles of k (sweep 1), then k
//   and v (sweep 2), into 128-byte-swizzled rings with full and empty
//   mbarriers, so the loads run ahead of the products and no block barrier
//   is taken after the set-up.
// The tensor maps are 4-D (64 lanes, rows, heads, batch) from the views'
// element strides, so K3's lane slices and K6's views take one map type.
// Ragged edges: rows past S in a q, k or v box arrive as zeros; keys past
// S get s = -inf in sweep 1 and p = 0 in sweep 2; query rows past S are
// computed and never stored (1568 = 12*128 + 32, 1569 = 12*128 + 33,
// 577 = 4*128 + 65), and a consumer with no row before S stops at once.
// In sweep 2 a consumer starts tile j + 1's q.k^T, then tile j's p.v, and
// runs tile j + 1's exp2 while p.v is on the tensor cores (p is formed in
// the q.k^T accumulator in place and packed once p.v has retired); the two
// consumers also overlap each other's work.
// The tiles of a (batch, head) are neighbours in the grid, so k and v come
// from L2 after the first tile reads them.
#include <stdio.h>

#include "fused_qkv_common.cuh"
#include "hopper.cuh"

using namespace unite;
using namespace hopper;

namespace {

constexpr int BLOCK_Q = 128;               // queries a block: 64 a consumer
constexpr int BLOCK_K = 128;               // keys a tile
constexpr int TILE_BYTES = 128 * 64 * 2;   // one q, k or v tile: 16 KB
constexpr int K_STAGES = 3;
constexpr int V_STAGES = 2;
constexpr int CONSUMERS = 256;             // threads of the two consumers
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
constexpr int SMEM_BYTES =
    1024 + TILE_BYTES * (1 + K_STAGES + V_STAGES) +
    8 * (1 + 2 * K_STAGES + 2 * V_STAGES);

struct Smem {
  bf16* q;
  bf16* k;  // K_STAGES tiles
  bf16* v;  // V_STAGES tiles
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* k_empty;
  uint64_t* v_full;
  uint64_t* v_empty;
};

__device__ __forceinline__ Smem carve(uint8_t* raw) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  uint8_t* p = raw + pad;
  Smem s;
  s.q = reinterpret_cast<bf16*>(p);
  s.k = reinterpret_cast<bf16*>(p + TILE_BYTES);
  s.v = reinterpret_cast<bf16*>(p + TILE_BYTES * (1 + K_STAGES));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(p + TILE_BYTES * (1 + K_STAGES + V_STAGES));
  s.q_full = bars;
  s.k_full = bars + 1;
  s.k_empty = s.k_full + K_STAGES;
  s.v_full = s.k_empty + K_STAGES;
  s.v_empty = s.v_full + V_STAGES;
  return s;
}

// The box of `map` at (row, h, b): `perm` holds, 2 bits each, the map
// dimension (1..3) of the row, head and batch coordinates.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int perm, int row,
                                         int h, int b) {
  const int pr = perm & 3, ph = (perm >> 2) & 3;
  const int c1 = pr == 1 ? row : ph == 1 ? h : b;
  const int c2 = pr == 2 ? row : ph == 2 ? h : b;
  const int c3 = pr == 3 ? row : ph == 3 ? h : b;
  mbar_expect_tx(bar, TILE_BYTES);
  tma_load_4d(dst, map, bar, 0, c1, c2, c3);
}

constexpr uint64_t TILE_UNITS = TILE_BYTES >> 4;  // a tile in descriptor units

// Start s = q . k^T for this warpgroup's 64 rows and a 128-key tile: four
// k-steps of 16 lanes, each 32 bytes further into the swizzle atom.
__device__ __forceinline__ void qk_start(float (&s)[64], uint64_t qd,
                                         uint64_t kd) {
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss(s, qd + 2 * kk, kd + 2 * kk, kk);
  wgmma_commit();
}

// Start acc += p . v for a 128-key tile: eight k-steps of 16 keys, each 16
// rows (2048 bytes) further into the tile.
__device__ __forceinline__ void pv_start(float (&acc)[32], uint32_t (&p)[8][4],
                                         uint64_t vd) {
  reg_fence(acc);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) reg_fence(p[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_rs_tb(acc, p[kk], vd + 128 * kk, 1);
  wgmma_commit();
}

// The n-th k tile the consumers take (sweep 1: n = j, sweep 2: n =
// ntiles + j) sits in stage n % K_STAGES, in phase (n / K_STAGES) & 1.
__device__ __forceinline__ void wait_k_start_qk(const Smem& sm, float (&s)[64],
                                                uint64_t qd, int n) {
  const int st = n % K_STAGES;
  mbar_wait(&sm.k_full[st], (n / K_STAGES) & 1);
  qk_start(s, qd, desc_b128(sm.k, 16, 1024) + st * TILE_UNITS);
}

__device__ __forceinline__ void free_k(const Smem& sm, int n) {
  mbar_arrive(&sm.k_empty[n % K_STAGES]);
}

// The row max over this lane's columns of a tile whose first `valid` keys
// exist (rows g and g + 8 of the warp).
template <bool MASK>
__device__ __forceinline__ void tile_max(const float (&s)[64], int valid,
                                         int t, float& m0, float& m1) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int key = 8 * i + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!MASK || key + e < valid) {
        m0 = fmaxf(m0, s[4 * i + e]);
        m1 = fmaxf(m1, s[4 * i + 2 + e]);
      }
    }
  }
}

// p = exp2((s - m)*c) rounded to bf16, in place (as fp32, exactly), with
// l summing the rounded values; keys at or past `valid` get p = 0.
template <bool MASK>
__device__ __forceinline__ void tile_exp(float (&s)[64], int valid, int t,
                                         float m0, float m1, float c,
                                         float& l0, float& l1) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int key = 8 * i + 2 * t;
    const bool ok0 = !MASK || key < valid, ok1 = !MASK || key + 1 < valid;
    const __nv_bfloat162 r0 = __floats2bfloat162_rn(  // row g
        ok0 ? fast_exp2((s[4 * i] - m0) * c) : 0.f,
        ok1 ? fast_exp2((s[4 * i + 1] - m0) * c) : 0.f);
    const __nv_bfloat162 r1 = __floats2bfloat162_rn(  // row g + 8
        ok0 ? fast_exp2((s[4 * i + 2] - m1) * c) : 0.f,
        ok1 ? fast_exp2((s[4 * i + 3] - m1) * c) : 0.f);
    s[4 * i] = __low2float(r0);
    s[4 * i + 1] = __high2float(r0);
    s[4 * i + 2] = __low2float(r1);
    s[4 * i + 3] = __high2float(r1);
    l0 += s[4 * i] + s[4 * i + 1];
    l1 += s[4 * i + 2] + s[4 * i + 3];
  }
}

__device__ __forceinline__ void exp_tile(float (&s)[64], int j, int S, int t,
                                         float m0, float m1, float c,
                                         float& l0, float& l1) {
  const int valid = S - j * BLOCK_K;
  if (valid >= BLOCK_K)
    tile_exp<false>(s, valid, t, m0, m1, c, l0, l1);
  else
    tile_exp<true>(s, valid, t, m0, m1, c, l0, l1);
}

// The rounded p as the A fragments of the p.v product: k-step kk covers
// keys 16kk..16kk+15, n8 blocks 2kk and 2kk + 1 of the accumulator, so the
// m64n128 accumulator re-packs with no shuffles.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * kk + half;
      p[kk][2 * half] = pack_f32(s[4 * i], s[4 * i + 1]);          // row g
      p[kk][2 * half + 1] = pack_f32(s[4 * i + 2], s[4 * i + 3]);  // row g + 8
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, View o,
                           float* __restrict__ lse, int S, int H, float c,
                           int perms) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem sm = carve(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int ntiles = (S + BLOCK_K - 1) / BLOCK_K;
  const int wg = threadIdx.x >> 7;
  // a consumer whose 64 rows all lie past S (the second one of the last
  // tile at 1568 or 1569) has nothing to compute or release
  const bool second_live = q0 + 64 < S;

  if (threadIdx.x == 0) {
    const int consumers = second_live ? CONSUMERS : CONSUMERS / 2;
    mbar_init(sm.q_full, 1);
    for (int i = 0; i < K_STAGES; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.k_empty[i], consumers);
    }
    for (int i = 0; i < V_STAGES; ++i) {
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.v_empty[i], consumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      const int pq = perms & 63, pk = (perms >> 6) & 63, pvm = perms >> 12;
      load_box(sm.q, &q_map, sm.q_full, pq, q0, h, b);
      // k tiles n = 0 .. 2*ntiles - 1 (sweep 1, then sweep 2) and, in
      // sweep 2, v tile n - ntiles after each k tile, as the consumers take
      // them (wait_k_start_qk)
      for (int n = 0; n < 2 * ntiles; ++n) {
        const int ks = n % K_STAGES;
        mbar_wait(&sm.k_empty[ks], ((n / K_STAGES) & 1) ^ 1);
        load_box(sm.k + ks * (TILE_BYTES / 2), &k_map, &sm.k_full[ks], pk,
                 (n % ntiles) * BLOCK_K, h, b);
        const int j = n - ntiles, vs = j % V_STAGES;
        if (j < 0) continue;
        mbar_wait(&sm.v_empty[vs], ((j / V_STAGES) & 1) ^ 1);
        load_box(sm.v + vs * (TILE_BYTES / 2), &v_map, &sm.v_full[vs], pvm,
                 j * BLOCK_K, h, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    if (wg == 1 && !second_live) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
    const uint64_t qd = desc_b128(sm.q + wg * 64 * 64, 16, 1024);
    float s[64], s2[64];
    mbar_wait(sm.q_full, 0);

    // sweep 1: the exact row max over every valid key. Tile j + 1's q.k^T
    // runs while tile j's max is taken, in two accumulators; the loop body
    // is the same on every pass (the last one or two tiles are peeled), so
    // ptxas can tell which product a wait retires.
    float m0 = -INFINITY, m1 = -INFINITY;
    wait_k_start_qk(sm, s, qd, 0);
    int j = 0;
    for (; j + 2 < ntiles; j += 2) {  // tiles j, j + 1 full; j + 2 exists
      wait_k_start_qk(sm, s2, qd, j + 1);
      wgmma_wait<1>();
      reg_fence(s);
      free_k(sm, j);
      tile_max<false>(s, BLOCK_K, t, m0, m1);
      wait_k_start_qk(sm, s, qd, j + 2);
      wgmma_wait<1>();
      reg_fence(s2);
      free_k(sm, j + 1);
      tile_max<false>(s2, BLOCK_K, t, m0, m1);
    }
    const int last = S - (ntiles - 1) * BLOCK_K;  // keys of the last tile
    if (j + 2 == ntiles) {  // s holds tile j (full); tile j + 1 is the last
      wait_k_start_qk(sm, s2, qd, j + 1);
      wgmma_wait<1>();
      reg_fence(s);
      free_k(sm, j);
      tile_max<false>(s, BLOCK_K, t, m0, m1);
      wgmma_wait<0>();
      reg_fence(s2);
      free_k(sm, j + 1);
      if (last >= BLOCK_K)
        tile_max<false>(s2, last, t, m0, m1);
      else
        tile_max<true>(s2, last, t, m0, m1);
    } else {  // s holds the last tile
      wgmma_wait<0>();
      reg_fence(s);
      free_k(sm, j);
      if (last >= BLOCK_K)
        tile_max<false>(s, last, t, m0, m1);
      else
        tile_max<true>(s, last, t, m0, m1);
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // sweep 2: p against m, l = rowsum(rounded p), acc = p.v. Tile j + 1's
    // q.k^T starts before tile j's p.v, and its exp2 runs while p.v does.
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    uint32_t p[8][4];
    wait_k_start_qk(sm, s, qd, ntiles);
    wgmma_wait<0>();
    reg_fence(s);
    free_k(sm, ntiles);
    exp_tile(s, 0, S, t, m0, m1, c, l0, l1);
    pack_p(s, p);
    for (int j = 0; j + 1 < ntiles; ++j) {
      wait_k_start_qk(sm, s, qd, ntiles + j + 1);
      const int vs = j % V_STAGES;
      mbar_wait(&sm.v_full[vs], (j / V_STAGES) & 1);
      pv_start(acc, p, desc_b128(sm.v, 0, 1024) + vs * TILE_UNITS);
      wgmma_wait<1>();  // products retire in order: q.k^T is done
      reg_fence(s);
      free_k(sm, ntiles + j + 1);
      exp_tile(s, j + 1, S, t, m0, m1, c, l0, l1);
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(&sm.v_empty[vs]);
      pack_p(s, p);
    }
    {
      const int j = ntiles - 1, vs = j % V_STAGES;
      mbar_wait(&sm.v_full[vs], (j / V_STAGES) & 1);
      pv_start(acc, p, desc_b128(sm.v, 0, 1024) + vs * TILE_UNITS);
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(&sm.v_empty[vs]);
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // o = acc * (1/l) in bf16, rows past S dropped; lse2 = m*c + log2(l)
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* ob = o.head(b, h);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + row0 * o.sr + col) =
            pack_f32(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * o.sr + col) =
            pack_f32(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
    if (lse != nullptr && t == 0) {
      const size_t row = ((size_t)b * H + h) * S + row0;
      if (row0 < S) lse[row] = m0 * c + log2f(l0);
      if (row0 + 8 < S) lse[row + 8] = m1 * c + log2f(l1);
    }
  }
}

// The 4-D map (64 lanes, then the row, head and batch dimensions) of a
// [B, H, S, 64] bf16 view with element strides st = (batch, head, row), in
// 128-row boxes with 128-byte swizzle. cuTensorMapEncodeTiled's
// documentation gives each stride as at least the span of the dimensions
// inside it, which K3's lane slices
// (head stride 64, row stride 3*H*64) break in (row, head, batch) order:
// so dimensions of extent > 1 go in order of stride, and one of extent 1
// goes after them with the stride of a packed layout (its own stride may
// be anything). *perm gets, 2 bits each, the map dimension of the row,
// head and batch coordinates.
int encode_view(CUtensorMap* map, const void* base, const long long* st,
                int B, int H, int S, int* perm) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  struct Dim {
    long long extent, stride;
    int which;  // 0 row, 1 head, 2 batch
  } d[3] = {{S, st[2], 0}, {H, st[1], 1}, {B, st[0], 2}};
  auto before = [](const Dim& x, const Dim& y) {
    if ((x.extent == 1) != (y.extent == 1)) return y.extent == 1;
    return x.extent > 1 && x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(d[j], d[j - 1]); --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {64, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, elem[4] = {1, 1, 1, 1};
  cuuint64_t span = 64 * sizeof(bf16);
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)d[i].extent;
    strides[i] = d[i].extent > 1 ? (cuuint64_t)d[i].stride * sizeof(bf16) : span;
    span = strides[i] * dims[i + 1];
    if (d[i].which == 0) box[i + 1] = 128;
    *perm |= (i + 1) << (2 * d[i].which);
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr,
            "unite_flash_fwd: cuTensorMapEncodeTiled failed (%d) for dims "
            "(64, %llu, %llu, %llu), strides (%llu, %llu, %llu) bytes\n",
            (int)r, (unsigned long long)dims[1], (unsigned long long)dims[2],
            (unsigned long long)dims[3], (unsigned long long)strides[0],
            (unsigned long long)strides[1], (unsigned long long)strides[2]);
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q, k, v -> o, each a [B, H, S, 64] bf16 view whose (batch, head, row)
// strides in elements are strides[3i..3i+2] for i = q, k, v, o; lse
// [B, H, S] fp32 contiguous, or null. c = scale*log2(e). q, k and v need
// 16-byte aligned bases and strides that are multiples of 8 elements (for
// a dimension of extent > 1). Launches on `stream`; returns a CUDA error
// code (that of the launch, or of a tensor map that could not be made).
extern "C" int unite_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const long long* strides,
                               int B, int S, int H, float c, void* stream) {
  CUtensorMap maps[3];
  int perm[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_view(&maps[i], ptrs[i], strides + 3 * i, B, H, S,
                                &perm[i]);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  flash_fwd_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], view_of(o, strides, 3),
      static_cast<float*>(lse), S, H, c,
      perm[0] | (perm[1] << 6) | (perm[2] << 12));
  return (int)cudaGetLastError();
}
