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
// What bounds it: operations. At the stage-3 CLS shape [2, 12, 1569, 64]
// the forward is 6*S^2*D flops a head with the exact-max sweep (2.3e10,
// 0.34 ms at the H100's 67 TFLOP/s fp32) against 0.1 GB moved (0.03 ms at
// 3.35 TB/s); the backward's dq and dk/dv are 8*S^2*D and 8*S^2*D.
//
// Design: simple and right first. A block of 256 threads takes one 64-row
// tile of queries (fwd, dq) or keys (dk/dv) of one head, kept in shared
// memory with its cotangent rows; it walks the other side in 64-row tiles
// through shared memory, so nothing is resident per head and there is no
// sequence cap. Threads form a 16 x 16 grid; a thread holds a 4 x 4 block of
// a 64 x 64 score tile (rows ty + 16i, columns tx + 16j) and 4 rows of
// D/16 output lanes (tx + 16j). Tiles are stored with rows of D + 1 floats
// and score tiles with rows of 65, so the column reads of a half warp fall
// in distinct banks. Row statistics reduce over the 16 threads of a row
// group, which are one half warp (shuffles). The forward sweeps the keys
// twice: the row max first, then p, l and p.v against it (an online
// rescale would round p against a running max, another function). Rows
// and keys past S load as zeros; keys past S get p = 0 and are left out of
// the max; query rows past S are computed and never stored.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;       // query or key rows of a tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads
constexpr int PAD = TILE + 1;  // a score tile's row length in shared memory

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

template <int D>
__host__ __device__ constexpr int tile_floats() {
  return TILE * (D + 1);
}

// Rows [r0, r0 + TILE) of head (b, h) of x into a [TILE][D + 1] tile; rows
// at or past S as zeros.
template <int D>
__device__ void load_tile(float* t, const View& x, int b, int h, int r0,
                          int S) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    t[r * (D + 1) + c] = r0 + r < S ? x.row(b, h, r0 + r)[c] : 0.f;
  }
}

// s[i][j] = a[row ty + 16i] . b[row tx + 16j] over the D lanes of two tiles.
template <int D>
__device__ void dot_tile(const float* a, const float* b, float (&s)[4][4],
                         int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][j] += sum over the TILE rows r of w[ty + 16i][r] * x[r][tx + 16j]:
// a [TILE][PAD] score tile times a [TILE][D + 1] tile.
template <int D>
__device__ void acc_tile(const float* w, const float* x,
                         float (&acc)[4][D / 16], int tx, int ty) {
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    float y[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = x[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wv = w[(ty + 16 * i) * PAD + r];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(wv, y[j], acc[i][j]);
    }
  }
}

// The sum and the max over the 16 threads of a row group (a half warp).
__device__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ long long stat_index(int b, int h, int H, int S, int r) {
  return ((long long)b * H + h) * S + r;
}

// o (and lse2 where lse is not null) for one 64-query tile of one head.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    fwd_kernel(View q, View k, View v, View o, float* lse, int S, int H,
               float c) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + tile_floats<D>();
  float* vs = ks + tile_floats<D>();
  float* ps = vs + tile_floats<D>();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  load_tile<D>(qs, q, b, h, q0, S);

  // sweep 1: the exact row max of q.k^T over every key
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY;
  for (int k0 = 0; k0 < S; k0 += TILE) {
    __syncthreads();  // the previous tile is read (and the q tile written)
    load_tile<D>(ks, k, b, h, k0, S);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(qs, ks, s, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= S) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row_max(m[i]);

  // sweep 2: p = exp2((s - m)*c) in fp32, l = rowsum(p), acc = p.v
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < S; k0 += TILE) {
    __syncthreads();
    load_tile<D>(ks, k, b, h, k0, S);
    load_tile<D>(vs, v, b, h, k0, S);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(qs, ks, s, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key = k0 + tx + 16 * j < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key ? exp2f((s[i][j] - m[i]) * c) : 0.f;
        l[i] += p;
        ps[(ty + 16 * i) * PAD + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    acc_tile<D>(ps, vs, acc, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = row_sum(l[i]);
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      float* out = o.row(b, h, r);
      const float il = 1.f / li;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) out[tx + 16 * j] = acc[i][j] * il;
      if (lse != nullptr && tx == 0)
        lse[stat_index(b, h, H, S, r)] = m[i] * c + log2f(li);
    }
  }
}

// dq and delta = rowsum(do * o) for one 64-query tile of one head.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    dq_kernel(View q, View k, View v, View o, View dout, const float* lse,
              float* delta, View dq, int S, int H, float c, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + tile_floats<D>();
  float* ks = gs + tile_floats<D>();
  float* vs = ks + tile_floats<D>();
  float* ds = vs + tile_floats<D>();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  load_tile<D>(qs, q, b, h, q0, S);
  load_tile<D>(gs, dout, b, h, q0, S);
  __syncthreads();
  float dl[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    float part = 0.f;
    if (r < S) {
      const float* orow = o.row(b, h, r);
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        part = fmaf(gs[(ty + 16 * i) * (D + 1) + tx + 16 * j],
                    orow[tx + 16 * j], part);
    }
    dl[i] = row_sum(part);
    ls[i] = r < S ? lse[stat_index(b, h, H, S, r)] : 0.f;
    if (r < S && tx == 0) delta[stat_index(b, h, H, S, r)] = dl[i];
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < S; k0 += TILE) {
    __syncthreads();
    load_tile<D>(ks, k, b, h, k0, S);
    load_tile<D>(vs, v, b, h, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(qs, ks, s, tx, ty);
    dot_tile<D>(gs, vs, dp, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key = k0 + tx + 16 * j < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key ? exp2f(s[i][j] * c - ls[i]) : 0.f;
        ds[(ty + 16 * i) * PAD + tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();
    acc_tile<D>(ds, ks, acc, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      float* out = dq.row(b, h, r);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) out[tx + 16 * j] = acc[i][j];
    }
  }
}

// dk and dv for one 64-key tile of one head, from the forward's lse2 and
// the dq kernel's delta.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    dkv_kernel(View q, View k, View v, View dout, const float* lse,
               const float* delta, View dk, View dv, int S, int H, float c,
               float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + tile_floats<D>();
  float* qs = vs + tile_floats<D>();
  float* gs = qs + tile_floats<D>();
  float* ws = gs + tile_floats<D>();  // p^T, then ds^T
  float* lq = ws + TILE * PAD;        // the query tile's lse2 and delta
  float* dlq = lq + TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  load_tile<D>(ks, k, b, h, k0, S);
  load_tile<D>(vs, v, b, h, k0, S);

  float adk[4][D / 16], adv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) adk[i][j] = adv[i][j] = 0.f;
  for (int q0 = 0; q0 < S; q0 += TILE) {
    __syncthreads();
    load_tile<D>(qs, q, b, h, q0, S);
    load_tile<D>(gs, dout, b, h, q0, S);
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
      const bool row = q0 + t < S;
      lq[t] = row ? lse[stat_index(b, h, H, S, q0 + t)] : 0.f;
      dlq[t] = row ? delta[stat_index(b, h, H, S, q0 + t)] : 0.f;
    }
    __syncthreads();
    // rows: this block's keys (ty); columns: the tile's queries (tx)
    float s[4][4], dp[4][4];
    dot_tile<D>(ks, qs, s, tx, ty);
    dot_tile<D>(vs, gs, dp, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const bool query = q0 + col < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = query ? exp2f(s[i][j] * c - lq[col]) : 0.f;
        ws[(ty + 16 * i) * PAD + col] = p;
        dp[i][j] = p * (dp[i][j] - dlq[col]) * scale;
      }
    }
    __syncthreads();
    acc_tile<D>(ws, gs, adv, tx, ty);  // dv += p^T . do
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ws[(ty + 16 * i) * PAD + tx + 16 * j] = dp[i][j];
    __syncthreads();
    acc_tile<D>(ws, qs, adk, tx, ty);  // dk += ds^T . q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r < S) {
      float* gk = dk.row(b, h, r);
      float* gv = dv.row(b, h, r);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        gk[tx + 16 * j] = adk[i][j];
        gv[tx + 16 * j] = adv[i][j];
      }
    }
  }
}

template <int D>
constexpr int fwd_bytes() {
  return (3 * tile_floats<D>() + TILE * PAD) * (int)sizeof(float);
}

template <int D>
constexpr int bwd_bytes() {
  return (4 * tile_floats<D>() + TILE * PAD + 2 * TILE) * (int)sizeof(float);
}

template <typename Kernel>
int launchable(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

dim3 grid_of(int B, int S, int H) {
  return dim3((S + TILE - 1) / TILE, H, B);
}

template <int D>
int run_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
            const long long* strides, int B, int S, int H, float c,
            void* stream) {
  int err = launchable(fwd_kernel<D>, fwd_bytes<D>());
  if (err != 0) return err;
  fwd_kernel<D><<<grid_of(B, S, H), THREADS, fwd_bytes<D>(),
                  (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), static_cast<float*>(lse), S, H, c);
  return (int)cudaGetLastError();
}

template <int D>
int run_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           const long long* strides, int B, int S, int H, float c,
           float scale, void* stream) {
  int err = launchable(dq_kernel<D>, bwd_bytes<D>());
  if (err != 0) return err;
  dq_kernel<D><<<grid_of(B, S, H), THREADS, bwd_bytes<D>(),
                 (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(o, strides, 3), view_of(dout, strides, 4),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      view_of(dq, strides, 5), S, H, c, scale);
  return (int)cudaGetLastError();
}

template <int D>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const long long* strides, int B, int S, int H, float c,
            float scale, void* stream) {
  int err = launchable(dkv_kernel<D>, bwd_bytes<D>());
  if (err != 0) return err;
  dkv_kernel<D><<<grid_of(B, S, H), THREADS, bwd_bytes<D>(),
                  (cudaStream_t)stream>>>(
      view_of(q, strides, 0), view_of(k, strides, 1), view_of(v, strides, 2),
      view_of(dout, strides, 3), static_cast<const float*>(lse),
      static_cast<const float*>(delta), view_of(dk, strides, 4),
      view_of(dv, strides, 5), S, H, c, scale);
  return (int)cudaGetLastError();
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
