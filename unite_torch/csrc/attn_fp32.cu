// Attention in fp32 for Hopper (sm_90a): the card's path when a model
// computes in float32 (--compute_dtype float32), over strided [B, H, S, D]
// fp32 views, any sequence length, head dims 64 and 80.
//
// What it replaces. On the TPU every attention kernel casts only to its
// inputs' dtype (unite_tpu/ops/attention.py :167, :289, :487, :701, :795,
// :930, :1035), so an fp32 model runs K1-K6 in fp32:
//   K1 _fused_qkv_kernel, K2 _fused_qkv_bwd_kernel (packed qkv, S <= 512),
//   K3 _packed_fwd_kernel, K4a/K4b _packed_dq_kernel/_packed_dkv_kernel
//   (packed qkv, S > 512), K5 _grouped_fwd_kernel/_grouped_bwd_kernel and
//   K6 _fwd_kernel/_bwd_dq_kernel/_bwd_dkv_kernel ([B, H, S, D]).
// Their rounding points (bf16 p, bf16 p^T, K5's do/l) are casts to the
// input dtype and identities at fp32, so at fp32 the six compute one
// function up to summation order, and one forward and one backward pair
// serve every route (the wrappers in unite_torch/ops/attention.py pass
// packed-qkv lane slices, strided views or contiguous tensors alike):
//
//   unite_fp32_attn_fwd  o = softmax(q.k^T * scale) . v and, when asked,
//                        lse2 = m*c + log2(l) [B, H, S] fp32, with the
//                        EXACT row max m over all keys (as every TPU kernel
//                        takes it), p = exp2((s - m)*c) kept in fp32,
//                        l = rowsum(p), o = (p.v) * (1/l);
//   unite_fp32_attn_dq   delta = rowsum(do * o) (written out for dK/dV),
//                        p = exp2(s*c - lse2), ds = p*(do.v^T - delta)*scale,
//                        dq = ds.k;
//   unite_fp32_attn_dkv  p^T and ds^T the same way by key row,
//                        dv = p^T.do, dk = ds^T.q.
// c = scale*log2(e). The plain version is attention_fp32_reference (and its
// backward) in unite_torch/ops/attention.py.
//
// Hopper's tensor cores take no fp32 operands: TF32 rounds each operand to
// 10 mantissa bits, which is another function. So every product here is an
// fp32 FMA on the SMs' cores, and the bf16 route keeps its wgmma kernels.
//
// What bounds it: operations. At [2, 12, 1568, 64] the forward is 6*S^2*D
// flops a head with the exact-max sweep (2.3e10, 0.34 ms at the H100's 67
// TFLOP/s fp32) against 0.1 GB moved (0.03 ms at 3.35 TB/s); dq is 6*S^2*D
// and dk/dv 8*S^2*D. An SM's 128 fp32 lanes do 128 FMAs a clock while its
// shared memory serves 128 bytes a clock, so a product whose operands come
// from shared memory one scalar per FMA or two runs at the shared memory's
// pace, not the FMAs'.
//
// All three entries (fwd_kernel, dq_kernel, dkv_kernel) are register-tiled:
// * A block holds rows of its own side (queries; keys for dK/dV) and
//   streams the other side in 64-row tiles: the forward 4 warps over 8*TM
//   query rows, dQ 8 warps over 16*TM queries and dK/dV over 16*TM keys
//   (two rows of 4 warps). A warp's lanes form 8 row groups lr by 4 column
//   groups lc; a thread of warp w holds a TM x 4 block of a 64-column score
//   tile (rows lr + 8i, columns 16(w % 4) + lc + 4j) and a TM x 4 block of
//   the D output lanes (lanes 16(w % 4) + 4lc .. +3; at D = 80 also lane
//   64 + 4(w % 4) + lc).
// * Every operand is read with 16-byte loads from row-major tiles: the
//   products over D (q.k^T, do.v^T, v.do^T) load 4 lanes of both rows a
//   load, the products over the streamed rows (p.v, ds.k, p^T.do, ds^T.q)
//   4 columns of the score tile and 4 output lanes of a streamed row. Tile
//   rows are D + 4 floats (score tiles 68), so the 8 row groups' 16-byte
//   loads fall in 8 distinct 16-byte bank groups and the 4 column groups'
//   in 4: each load is one shared-memory wavefront, and a thread does 8
//   (TM = 4) to 10.7 (TM = 8) FMAs a load.
// * The streamed tiles come in by 16-byte cp.async copies through a ring,
//   so a tile's copy runs under the products of the tile before. The
//   forward's first sweep (the exact row max) streams K alone through 3
//   slots with one barrier a tile; its second streams K_t and V_t through
//   the same 3 slots (K_t in slot 2t mod 3, V_t in 2t + 1 mod 3: K_{t+1} is
//   copied into V_{t-1}'s slot once p.V_{t-1} is done, V_{t+1} into K_t's
//   once q.K_t is done) with two barriers a tile. dQ streams K_t and V_t
//   through 2 stages (stage t + 1 is copied once tile t - 1's ds.K is
//   done), writes ds into a tile of its own and keeps dq in registers: two
//   barriers a tile. dK/dV streams q, do, lse2 and delta through 2 stages,
//   writes p^T and ds^T into two tiles of their own and keeps dk and dv in
//   registers: two barriers a tile.
// * Row statistics (the forward's max, then l; dQ's delta = rowsum(do*o),
//   once before its loop) reduce over a row's 4 column groups by shuffles
//   and over the 4 warps through shared memory.
// * The grid: each entry takes the tile whose grid costs least
//   (grid_cost: the blocks an SM takes in turn, a smaller tile costing
//   more a row), the forward 32 or 64 query rows, dQ 64, 80 or 112, dK/dV
//   64 to 128 keys.
// Rows and keys past S load as zeros (cp.async's zero fill), and so do
// lse2 and delta past S; keys past S get p = 0 and are left out of the
// max; query rows past S are computed and never stored, nor their delta.
// The forward sweeps the keys twice, the row max first, then p, l and p.v
// against it (an online rescale would round p against a running max,
// another function).

#include <cuda_runtime.h>
#include <math.h>

namespace {

// A [B, H, S, D] fp32 tensor: its pointer and the element strides of B, H
// and S; the D lanes of a row are contiguous.
struct View {
  float* p;
  long long sb, sh, ss;
  __device__ float* row(int b, int h, int i) const {
    return p + b * sb + h * sh + (long long)i * ss;
  }
};

View view_of(const void* p, const long long* strides, int i) {
  return View{const_cast<float*>(static_cast<const float*>(p)),
              strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

__device__ long long stat_index(int b, int h, int H, int S, int r) {
  return ((long long)b * H + h) * S + r;
}

constexpr int COLS = 64;         // rows of a streamed tile
constexpr int LDP = COLS + 4;    // a score tile's row length
constexpr int RING = 3;          // the forward's slots
constexpr int SMEM_MAX = 232448; // a block's shared memory on sm_90

template <int D>
__host__ __device__ constexpr int ld_of() {  // an operand tile's row length
  return D + 4;
}

template <int D>
__host__ __device__ constexpr int lanes_of() {  // output lanes a thread holds
  return D == 80 ? 5 : 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros where
// !valid (src is then a readable address that is not read).
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's latest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Rows [r0, r0 + R) of head (b, h) of x into an [R][D + 4] tile by 16-byte
// async copies from NT threads, rows at or past S as zeros.
template <int D, int R, int NT>
__device__ __forceinline__ void copy_tile(float* t, const View& x, int b,
                                          int h, int r0, int S) {
  constexpr int C = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int n = 0; n < (R * C + NT - 1) / NT; ++n) {
    const int e = threadIdx.x + n * NT, r = e / C, c = e - r * C;
    if (R * C % NT != 0 && e >= R * C) break;
    const bool ok = r0 + r < S;
    cp16(t + r * ld_of<D>() + 4 * c, x.row(b, h, ok ? r0 + r : 0) + 4 * c,
         ok);
  }
}

// Statistics [r0, r0 + COLS) of one head (from x + base) into t, past S as
// zeros.
template <int NT>
__device__ __forceinline__ void copy_stats(float* t, const float* x,
                                           long long base, int r0, int S) {
  for (int r = threadIdx.x; r < COLS; r += NT) {
    const bool ok = r0 + r < S;
    cp4(t + r, x + base + (ok ? r0 + r : 0), ok);
  }
}

// s[i][j] = a[ra + 8i] . b[cb + 4j] over the D lanes of two [.][D + 4]
// tiles, 4 lanes of each row a load.
template <int D, int TM>
__device__ __forceinline__ void dot_rows(const float* a, const float* b,
                                         float (&s)[TM][4], int ra, int cb) {
  constexpr int LD = ld_of<D>();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[TM], y[4];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = ld4(a + (ra + 8 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(b + (cb + 4 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// acc[i][.] += sum over the COLS columns r of w[ra + 8i][r] * x[r][lanes]:
// a [.][COLS + 4] score tile times a [COLS][D + 4] tile, the lanes lb .. lb
// + 3 and, at D = 80, le; 4 columns of w and 4 lanes of x a load.
template <int D, int TM>
__device__ __forceinline__ void acc_rows(const float* w, const float* x,
                                         float (&acc)[TM][lanes_of<D>()],
                                         int ra, int lb, int le) {
  constexpr int LD = ld_of<D>();
#pragma unroll 4
  for (int r = 0; r < COLS; r += 4) {
    float4 p[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) p[i] = ld4(w + (ra + 8 * i) * LDP + r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xr = x + (r + u) * LD;
      const float4 y = ld4(xr + lb);
      const float ye = D == 80 ? xr[le] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float pu = at(p[i], u);
        acc[i][0] = fmaf(pu, y.x, acc[i][0]);
        acc[i][1] = fmaf(pu, y.y, acc[i][1]);
        acc[i][2] = fmaf(pu, y.z, acc[i][2]);
        acc[i][3] = fmaf(pu, y.w, acc[i][3]);
        if constexpr (D == 80) acc[i][4] = fmaf(pu, ye, acc[i][4]);
      }
    }
  }
}

// Row r's outputs acc * f into out (a row of a view): lanes lb .. lb + 3 by
// one 16-byte store and, at D = 80, lane le.
template <int D>
__device__ __forceinline__ void store_lanes(float* out,
                                            const float (&acc)[lanes_of<D>()],
                                            float f, int lb, int le) {
  *reinterpret_cast<float4*>(out + lb) =
      make_float4(acc[0] * f, acc[1] * f, acc[2] * f, acc[3] * f);
  if constexpr (D == 80) out[le] = acc[4] * f;
}

// A thread's place in the register tiles: warp w takes rows 8*TM*(w / 4)
// onward and column quarter w % 4 of the score and output tiles.
template <int TM>
struct Place {
  int ra, cb, lb, le;
  __device__ Place() {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, wq = w & 3;
    const int lr = lane >> 2, lc = lane & 3;
    ra = 8 * TM * (w >> 2) + lr;  // rows ra + 8i
    cb = 16 * wq + lc;            // score columns cb + 4j
    lb = 16 * wq + 4 * lc;        // output lanes lb .. lb + 3
    le = 64 + 4 * wq + lc;        // and, at D = 80, le
  }
};

// o (and lse2 where lse is not null) for one tile of 8*TM queries of one
// head, 128 threads.
template <int D, int TM>
__global__ void __launch_bounds__(128, 2)
    fwd_kernel(View q, View k, View v, View o, float* lse, int S, int H,
               float c) {
  constexpr int LD = ld_of<D>(), ROWS = 8 * TM, NT = 128;
  extern __shared__ __align__(16) float tiles[];
  float* qs = tiles;                   // [ROWS][LD]
  float* ring = qs + ROWS * LD;        // RING x [COLS][LD]
  float* ps = ring + RING * COLS * LD; // [ROWS][LDP]
  float* red = ps + ROWS * LDP;        // [4 warps][ROWS]
  const Place<TM> at_;
  const int w = threadIdx.x >> 5, lc = threadIdx.x & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nt = (S + COLS - 1) / COLS;
  auto slot = [&](int i) { return ring + i * COLS * LD; };

  copy_tile<D, ROWS, NT>(qs, q, b, h, q0, S);
  cp_commit();
  copy_tile<D, COLS, NT>(slot(0), k, b, h, 0, S);
  cp_commit();
  if (nt > 1) copy_tile<D, COLS, NT>(slot(1), k, b, h, COLS, S);
  cp_commit();

  // sweep 1: the exact row max of q.k^T over every key; K_t in slot t % 3
  float m[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) m[i] = -INFINITY;
  for (int t = 0; t < nt; ++t) {
    cp_wait<1>();     // K_t has landed (K_{t+1} may be in flight)
    __syncthreads();  // ... for every thread, and q.K_{t-1} is done
    if (t + 2 < nt)
      copy_tile<D, COLS, NT>(slot((t + 2) % RING), k, b, h, (t + 2) * COLS,
                             S);
    cp_commit();
    float s[TM][4];
    dot_rows<D, TM>(qs, slot(t % RING), s, at_.ra, at_.cb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t * COLS + at_.cb + 4 * j >= S) continue;
#pragma unroll
      for (int i = 0; i < TM; ++i) m[i] = fmaxf(m[i], s[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    if (lc == 0) red[w * ROWS + at_.ra + 8 * i] = m[i];
  }
  __syncthreads();  // the maxima are in, and the ring is free
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = at_.ra + 8 * i;
    m[i] = fmaxf(fmaxf(red[r], red[ROWS + r]),
                 fmaxf(red[2 * ROWS + r], red[3 * ROWS + r]));
  }

  // sweep 2: p = exp2((s - m)*c) in fp32, l = rowsum(p), acc = p.v; K_t in
  // slot 2t % 3, V_t in slot (2t + 1) % 3
  copy_tile<D, COLS, NT>(slot(0), k, b, h, 0, S);
  cp_commit();
  copy_tile<D, COLS, NT>(slot(1), v, b, h, 0, S);
  cp_commit();
  float l[TM], acc[TM][lanes_of<D>()];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < lanes_of<D>(); ++j) acc[i][j] = 0.f;
  }
  for (int t = 0; t < nt; ++t) {
    const float* ks = slot((2 * t) % RING);
    const float* vs = slot((2 * t + 1) % RING);
    cp_wait<1>();     // K_t has landed (V_t may be in flight)
    __syncthreads();  // ... for every thread, and p.V_{t-1} is done
    if (t + 1 < nt)
      copy_tile<D, COLS, NT>(slot((2 * t + 2) % RING), k, b, h,
                             (t + 1) * COLS, S);
    cp_commit();
    float s[TM][4];
    dot_rows<D, TM>(qs, ks, s, at_.ra, at_.cb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key = t * COLS + at_.cb + 4 * j < S;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = key ? exp2f((s[i][j] - m[i]) * c) : 0.f;
        l[i] += p;
        ps[(at_.ra + 8 * i) * LDP + at_.cb + 4 * j] = p;
      }
    }
    cp_wait<1>();     // V_t has landed (K_{t+1} may be in flight)
    __syncthreads();  // p and V_t for every thread, and q.K_t is done
    if (t + 1 < nt)
      copy_tile<D, COLS, NT>(slot((2 * t + 3) % RING), v, b, h,
                             (t + 1) * COLS, S);
    cp_commit();
    acc_rows<D, TM>(ps, vs, acc, at_.ra, at_.lb, at_.le);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (lc == 0) red[w * ROWS + at_.ra + 8 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = at_.ra + 8 * i;
    if (q0 + r >= S) continue;
    const float li = red[r] + red[ROWS + r] + red[2 * ROWS + r] +
                     red[3 * ROWS + r];
    store_lanes<D>(o.row(b, h, q0 + r), acc[i], 1.f / li, at_.lb, at_.le);
    if (lse != nullptr && w == 0 && lc == 0)
      lse[stat_index(b, h, H, S, q0 + r)] = m[i] * c + log2f(li);
  }
}

// dq and delta = rowsum(do * o) for one tile of 16*TM queries of one head
// (8 warps), from the forward's lse2.
template <int D, int TM>
__global__ void __launch_bounds__(256, 1)
    dq_kernel(View q, View k, View v, View o, View dout, const float* lse,
              float* delta, View dq, int S, int H, float c, float scale) {
  constexpr int LD = ld_of<D>(), ROWS = 16 * TM, NT = 256;
  constexpr int STAGE = 2 * COLS * LD;  // K_t, V_t
  extern __shared__ __align__(16) float tiles[];
  float* qs = tiles;               // [ROWS][LD]
  float* gs = qs + ROWS * LD;      // do [ROWS][LD]
  float* dst = gs + ROWS * LD;     // ds [ROWS][LDP]; first delta's [4][ROWS]
  float* ring = dst + ROWS * LDP;  // 2 x STAGE
  const Place<TM> at_;
  const int wq = (threadIdx.x >> 5) & 3, lc = threadIdx.x & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nt = (S + COLS - 1) / COLS;
  const long long base = stat_index(b, h, H, S, 0);
  auto stage = [&](int t) {  // copy key tile t into stage t % 2
    float* st = ring + (t & 1) * STAGE;
    copy_tile<D, COLS, NT>(st, k, b, h, t * COLS, S);
    copy_tile<D, COLS, NT>(st + COLS * LD, v, b, h, t * COLS, S);
  };

  copy_tile<D, ROWS, NT>(qs, q, b, h, q0, S);
  copy_tile<D, ROWS, NT>(gs, dout, b, h, q0, S);
  cp_commit();
  stage(0);
  cp_commit();
  // delta: a thread's lanes of do*o, summed over a row's 4 column groups by
  // shuffles and over its 4 warps through shared memory
  float dl[TM], ls[TM];
  cp_wait<1>();     // q and do have landed (K_0, V_0 may be in flight)
  __syncthreads();  // ... for every thread
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = at_.ra + 8 * i;
    float part = 0.f;
    if (q0 + r < S) {
      const float* orow = o.row(b, h, q0 + r);
      const float* grow = gs + r * LD;
      const float4 x = ld4(grow + at_.lb), y = ld4(orow + at_.lb);
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
      part = fmaf(x.z, y.z, part);
      part = fmaf(x.w, y.w, part);
      if constexpr (D == 80) part = fmaf(grow[at_.le], orow[at_.le], part);
      ls[i] = lse[base + q0 + r];
    } else {
      ls[i] = 0.f;
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (lc == 0) dst[wq * ROWS + r] = part;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = at_.ra + 8 * i;
    dl[i] = dst[r] + dst[ROWS + r] + dst[2 * ROWS + r] + dst[3 * ROWS + r];
    if (q0 + r < S && wq == 0 && lc == 0) delta[base + q0 + r] = dl[i];
  }

  float acc[TM][lanes_of<D>()];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < lanes_of<D>(); ++j) acc[i][j] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const float* ks = ring + (t & 1) * STAGE;
    const float* vs = ks + COLS * LD;
    cp_wait<0>();     // key tile t has landed
    __syncthreads();  // ... for every thread, and tile t - 1 is done
    if (t + 1 < nt) stage(t + 1);
    cp_commit();
    // rows: this block's queries; columns: the tile's keys
    float s[TM][4], dp[TM][4];
    dot_rows<D, TM>(qs, ks, s, at_.ra, at_.cb);
    dot_rows<D, TM>(gs, vs, dp, at_.ra, at_.cb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = at_.cb + 4 * j;
      const bool key = t * COLS + col < S;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = key ? exp2f(s[i][j] * c - ls[i]) : 0.f;
        dst[(at_.ra + 8 * i) * LDP + col] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();  // ds for every thread
    acc_rows<D, TM>(dst, ks, acc, at_.ra, at_.lb, at_.le);  // dq += ds.k
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + at_.ra + 8 * i;
    if (r < S) store_lanes<D>(dq.row(b, h, r), acc[i], 1.f, at_.lb, at_.le);
  }
}

// dk and dv for one tile of 16*TM keys of one head (8 warps), from the
// forward's lse2 and the dq kernel's delta.
template <int D, int TM>
__global__ void __launch_bounds__(256, 1)
    dkv_kernel(View q, View k, View v, View dout, const float* lse,
               const float* delta, View dk, View dv, int S, int H, float c,
               float scale) {
  constexpr int LD = ld_of<D>(), ROWS = 16 * TM, NT = 256;
  constexpr int STAGE = 2 * COLS * LD + 2 * COLS;  // q, do, lse2, delta
  extern __shared__ __align__(16) float tiles[];
  float* ks = tiles;                 // [ROWS][LD]
  float* vs = ks + ROWS * LD;        // [ROWS][LD]
  float* pt = vs + ROWS * LD;        // p^T [ROWS][LDP]
  float* dst = pt + ROWS * LDP;      // ds^T [ROWS][LDP]
  float* ring = dst + ROWS * LDP;    // 2 x STAGE
  const Place<TM> at_;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nt = (S + COLS - 1) / COLS;
  const long long base = stat_index(b, h, H, S, 0);
  auto stage = [&](int t) {  // copy query tile t into stage t % 2
    float* st = ring + (t & 1) * STAGE;
    copy_tile<D, COLS, NT>(st, q, b, h, t * COLS, S);
    copy_tile<D, COLS, NT>(st + COLS * LD, dout, b, h, t * COLS, S);
    copy_stats<NT>(st + 2 * COLS * LD, lse, base, t * COLS, S);
    copy_stats<NT>(st + 2 * COLS * LD + COLS, delta, base, t * COLS, S);
  };

  copy_tile<D, ROWS, NT>(ks, k, b, h, k0, S);
  copy_tile<D, ROWS, NT>(vs, v, b, h, k0, S);
  stage(0);
  cp_commit();
  float adk[TM][lanes_of<D>()], adv[TM][lanes_of<D>()];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < lanes_of<D>(); ++j) adk[i][j] = adv[i][j] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const float* qs = ring + (t & 1) * STAGE;
    const float* gs = qs + COLS * LD;
    const float* lq = gs + COLS * LD;
    const float* dl = lq + COLS;
    cp_wait<0>();     // query tile t has landed
    __syncthreads();  // ... for every thread, and tile t - 1 is done
    if (t + 1 < nt) stage(t + 1);
    cp_commit();
    // rows: this block's keys; columns: the tile's queries
    float dp[TM][4], s[TM][4];
    dot_rows<D, TM>(vs, gs, dp, at_.ra, at_.cb);
    dot_rows<D, TM>(ks, qs, s, at_.ra, at_.cb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = at_.cb + 4 * j;
      const bool query = t * COLS + col < S;
      const float lse2 = lq[col], dlt = dl[col];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = query ? exp2f(s[i][j] * c - lse2) : 0.f;
        pt[(at_.ra + 8 * i) * LDP + col] = p;
        dst[(at_.ra + 8 * i) * LDP + col] = p * (dp[i][j] - dlt) * scale;
      }
    }
    __syncthreads();  // p^T and ds^T for every thread
    acc_rows<D, TM>(pt, gs, adv, at_.ra, at_.lb, at_.le);   // dv += p^T.do
    acc_rows<D, TM>(dst, qs, adk, at_.ra, at_.lb, at_.le);  // dk += ds^T.q
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = k0 + at_.ra + 8 * i;
    if (r >= S) continue;
    store_lanes<D>(dk.row(b, h, r), adk[i], 1.f, at_.lb, at_.le);
    store_lanes<D>(dv.row(b, h, r), adv[i], 1.f, at_.lb, at_.le);
  }
}

template <typename Kernel>
int launchable(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, int TM>
constexpr int fwd_bytes() {
  return (8 * TM * ld_of<D>() + RING * COLS * ld_of<D>() + 8 * TM * LDP +
          4 * 8 * TM) *
         (int)sizeof(float);
}

template <int D, int TM>
constexpr int dkv_bytes() {
  return (2 * 16 * TM * (ld_of<D>() + LDP) +
          2 * (2 * COLS * ld_of<D>() + 2 * COLS)) *
         (int)sizeof(float);
}

template <int D, int TM>
constexpr int dq_bytes() {
  return (16 * TM * (2 * ld_of<D>() + LDP) + 2 * 2 * COLS * ld_of<D>()) *
         (int)sizeof(float);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

// The blocks of a grid of tiles of the given rows.
long long blocks(int B, int S, int H, int rows) {
  return (long long)B * H * ((S + rows - 1) / rows);
}

// The relative time of a grid of tiles of the given rows, TM rows a
// thread, on sms SMs: the blocks an SM takes in turn, each costing
// TM * (1 + (8 - TM)/k). A smaller tile does fewer FMAs a shared load and
// pays its copies and barriers over fewer rows; k (40 for the forward, 20
// for dQ and dK/dV) fits the CUDA-graph times of every tile size at the main
// paths' shapes (unite_torch/tools/attention_ab.py --fp32).
double grid_cost(int B, int S, int H, int rows, int tm, int k, int sms) {
  return (double)((blocks(B, S, H, rows) + sms - 1) / sms) * tm *
         (1. + (8. - tm) / k);
}

template <int D, int TM>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const long long* strides, int B, int S, int H,
               float c, void* stream) {
  constexpr int bytes = fwd_bytes<D, TM>();
  int err = launchable(fwd_kernel<D, TM>, bytes);
  if (err != 0) return err;
  fwd_kernel<D, TM><<<dim3((S + 8 * TM - 1) / (8 * TM), H, B), 128, bytes,
                      (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), static_cast<float*>(lse), S, H, c);
  return (int)cudaGetLastError();
}

// 32- or 64-query tiles, whichever grid costs less.
template <int D>
int run_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
            const long long* strides, int B, int S, int H, float c,
            void* stream) {
  const int sms = sm_count();
  if (grid_cost(B, S, H, 32, 4, 40, sms) <
      grid_cost(B, S, H, 64, 8, 40, sms))
    return launch_fwd<D, 4>(q, k, v, o, lse, strides, B, S, H, c, stream);
  return launch_fwd<D, 8>(q, k, v, o, lse, strides, B, S, H, c, stream);
}

template <int D, int TM>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              const long long* strides, int B, int S, int H, float c,
              float scale, void* stream) {
  constexpr int rows = 16 * TM, bytes = dq_bytes<D, TM>();
  static_assert(bytes <= SMEM_MAX, "a block's shared memory");
  int err = launchable(dq_kernel<D, TM>, bytes);
  if (err != 0) return err;
  dq_kernel<D, TM><<<dim3((S + rows - 1) / rows, H, B), 256, bytes,
                      (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), view_of(dout, strides, 4),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      view_of(dq, strides, 5), S, H, c, scale);
  return (int)cudaGetLastError();
}

// dQ takes 16*TM queries a block (one block an SM), TM = 4, 5 or 7, the TM
// whose grid costs least: 112-query tiles at [2,12,1568] (3 waves of 336
// blocks over 132 SMs), 80 at [2,6,1568] and [2,12,392], 64 at the
// shortest. Of the TMs 4 to 8 timed at the main paths' shapes, these three
// hold the fastest at each.
template <int D>
int run_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           const long long* strides, int B, int S, int H, float c,
           float scale, void* stream) {
  const int sms = sm_count();
  const double c4 = grid_cost(B, S, H, 64, 4, 20, sms);
  const double c5 = grid_cost(B, S, H, 80, 5, 20, sms);
  const double c7 = grid_cost(B, S, H, 112, 7, 20, sms);
  auto run = [&](auto launch) {
    return launch(q, k, v, o, dout, lse, delta, dq, strides, B, S, H, c,
                  scale, stream);
  };
  if (c4 <= c5 && c4 <= c7) return run(launch_dq<D, 4>);
  if (c5 <= c7) return run(launch_dq<D, 5>);
  return run(launch_dq<D, 7>);
}

template <int D, int TM>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* strides, int B, int S, int H, float c,
               float scale, void* stream) {
  constexpr int rows = 16 * TM, bytes = dkv_bytes<D, TM>();
  static_assert(bytes <= SMEM_MAX, "a block's shared memory");
  int err = launchable(dkv_kernel<D, TM>, bytes);
  if (err != 0) return err;
  dkv_kernel<D, TM><<<dim3((S + rows - 1) / rows, H, B), 256, bytes,
                       (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(dout, strides, 3), static_cast<const float*>(lse),
      static_cast<const float*>(delta), view_of(dk, strides, 4),
      view_of(dv, strides, 5), S, H, c, scale);
  return (int)cudaGetLastError();
}

// The largest TM of dK/dV's tiles whose shared memory fits: 8 at D = 64,
// 7 at D = 80.
template <int D>
constexpr int dkv_max_tm() {
  return dkv_bytes<D, 8>() <= SMEM_MAX ? 8 : 7;
}

// launch_dkv<D, tm> for a tm in [TM, dkv_max_tm<D>()].
template <int D, int TM = 4, typename... Args>
int launch_dkv_at(int tm, Args... args) {
  if constexpr (TM < dkv_max_tm<D>())
    if (tm > TM) return launch_dkv_at<D, TM + 1>(tm, args...);
  return launch_dkv<D, TM>(args...);
}

// dK/dV takes 16*TM keys a block (TM = 4 .. dkv_max_tm, one block an SM),
// the TM whose grid costs least: 112-key tiles at [2,12,1568] (3 waves of
// 336 blocks over 132 SMs) rather than 128 (3 waves of 312) or 64 (5 of
// 600).
template <int D>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const long long* strides, int B, int S, int H, float c,
            float scale, void* stream) {
  const int sms = sm_count();
  int tm = 4;
  double least = grid_cost(B, S, H, 64, 4, 20, sms);
  for (int t = 5; t <= dkv_max_tm<D>(); ++t) {
    const double cost = grid_cost(B, S, H, 16 * t, t, 20, sms);
    if (cost < least) least = cost, tm = t;
  }
  return launch_dkv_at<D>(tm, q, k, v, dout, lse, delta, dk, dv, strides, B,
                          S, H, c, scale, stream);
}

bool shape_ok(int B, int S, int H) {
  return B > 0 && S > 0 && H > 0 && B <= 65535 && H <= 65535;
}

}  // namespace

// o and, where lse is not null, lse2 [B, H, S] (contiguous fp32). Views q,
// k, v, o with strides[3i..3i+2] (elements of B, H, S) in that order;
// c = scale * log2(e). The bf16 flash forward's argument list
// (flash_fwd_wgmma.cu).
extern "C" int unite_fp32_attn_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const long long* strides, int B, int S,
                                   int H, int D, float c, void* stream) {
  if (!shape_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  if (D == 64) return run_fwd<64>(q, k, v, o, lse, strides, B, S, H, c, stream);
  if (D == 80) return run_fwd<80>(q, k, v, o, lse, strides, B, S, H, c, stream);
  return (int)cudaErrorInvalidValue;
}

// dq, and delta = rowsum(do * o) [B, H, S] for unite_fp32_attn_dkv, from
// the forward's lse2. Views q, k, v, o, do, dq with strides[3i..3i+2] in
// that order. The bf16 flash dQ entry's argument list
// (flash_bwd_wgmma.cu).
extern "C" int unite_fp32_attn_dq(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* delta, void* dq,
                                  const long long* strides, int B, int S,
                                  int H, int D, float c, float scale,
                                  void* stream) {
  if (!shape_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return run_dq<64>(q, k, v, o, dout, lse, delta, dq, strides, B, S, H, c,
                      scale, stream);
  if (D == 80)
    return run_dq<80>(q, k, v, o, dout, lse, delta, dq, strides, B, S, H, c,
                      scale, stream);
  return (int)cudaErrorInvalidValue;
}

// dk and dv from the forward's lse2 and the dq entry's delta. Views q, k,
// v, do, dk, dv with strides[3i..3i+2] in that order. The bf16 flash dK/dV
// entry's argument list (flash_bwd_wgmma.cu).
extern "C" int unite_fp32_attn_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv,
                                   const long long* strides, int B, int S,
                                   int H, int D, float c, float scale,
                                   void* stream) {
  if (!shape_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return run_dkv<64>(q, k, v, dout, lse, delta, dk, dv, strides, B, S, H,
                       c, scale, stream);
  if (D == 80)
    return run_dkv<80>(q, k, v, dout, lse, delta, dk, dv, strides, B, S, H,
                       c, scale, stream);
  return (int)cudaErrorInvalidValue;
}
