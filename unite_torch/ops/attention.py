"""Multi-head attention: plain PyTorch references and the hand-written kernels.

Counterpart of unite_tpu/ops/attention.py. The models call ``self_attention``
on the qkv projection's natural [B, S, 3*H*D] layout, and it copies the JAX
package's dispatch (models/layers.py:174-190, models/clip.py:82-108):

* where ``use_fused_qkv`` accepts, ``fused_qkv_attention`` consumes qkv and
  returns [B, S, H*D] with the head split and merge done inside the kernels:
  S <= 384 in training and S <= 512 forward-only (``fwd_only``, JAX's
  ``deterministic``), at widths that are a multiple of 128, take the
  fused-qkv kernels, the short-sequence forward csrc/short_attn_wgmma.cu
  (K1) and backward csrc/short_bwd_wgmma.cu (K2); longer sequences with a
  divisor query block (1568, 1000, 600, ...) take the packed flash kernels,
  csrc/flash_fwd_wgmma.cu (K3) and the dQ and dK/dV kernels of
  csrc/flash_bwd_wgmma.cu (K4);
* everywhere else q, k and v become strided [B, H, S, D] views of qkv and
  ``multi_head_attention`` runs on them: up to 512 tokens the grouped
  kernels K5 (training at 385-512 tokens, 392 = stage 1 at mask 0.75, and
  widths that are not a multiple of 128), the forward in
  csrc/short_attn_wgmma.cu (K1's kernel body with K5's statistics) and the
  dQ and dK/dV kernels in csrc/short_bwd_wgmma.cu (K2's kernel bodies
  with K5's rounding points); above 512 tokens (1569 = 1568 patches + CLS,
  577, 785, ...) the blocked flash kernels K6, the same CUDA kernels as
  K3/K4, which take per-tensor strides. Each has its own launch counter;
  K1's, K3's and the bf16 K6's forwards also count their launches by
  (B, S) in ``.by_shape``, since one path runs each at more than one
  shape.

Beside each kernel is its plain version, with the TPU kernel's math and
rounding points; a wrapper uses it only for a tensor on the CPU. On CUDA
each wrapper chooses its kernel by dtype, under the same route:

* bf16 launches the route's ``wgmma`` kernel named above;
* float32 (``--compute_dtype float32``) launches the SIMT kernels of
  csrc/attn_fp32.cu, ``fp32_attn_fwd``, ``fp32_attn_dq`` and
  ``fp32_attn_dkv``, on every route. The JAX kernels cast only to their
  inputs' dtype, so on the TPU an fp32 model runs K1-K6 in fp32, where
  their rounding points are identities and the six compute one function
  (plain version: ``attention_fp32_reference`` and its backward). Hopper's
  tensor cores take no fp32 operands (TF32 is another function), so these
  kernels are fp32 FMAs on the SMs' cores. They count their launches
  apart from the route's wrappers, by route in ``.by_route``;
* any other dtype raises ``TypeError``. No CUDA tensor takes a plain
  version, and no failure to build or launch is caught.

Head dims: every kernel, K1-K6, was built for ``HEAD_DIMS`` (64, and 80
for ``pretrain_videomae_huge_patch16_224``, whose encoder and decoder both
have 80-lane heads); the C entry points take D and dispatch to a kernel
body templated on it. On CUDA any other head dim raises; the plain
versions take any.

All kernels fold the softmax scale into a base-2 exponent,
exp(s*scale - m*scale) == exp2((s - m)*c) with c = scale*log2(e). The flash
kernels' saved row statistic is the base-2 log-sum-exp of the scaled
scores, lse2 = m*c + log2(l), [B, H, S] fp32 (the TPU kernels broadcast it
to [B, H, S, 8]); K5 saves the raw row max m and the row sum l instead
(at fp32 on CUDA, the output o and lse2, which the fp32 backward takes).
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Optional

import torch

from unite_torch.ops import _build

INV_LN2 = 1.4426950408889634  # log2(e)
# What the CUDA path takes: bf16 (the wgmma kernels) and fp32 (the SIMT
# kernels of csrc/attn_fp32.cu)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# The head dims every kernel (K1-K6) was built for
HEAD_DIMS = (64, 80)
# The route: K1/K2 up to this length (unite_tpu's FUSED_QKV_FWD_MAX_SEQ);
# JAX's training cap FUSED_QKV_MAX_SEQ = 384 enters only use_fused_qkv.
FUSED_QKV_FWD_MAX_SEQ = 512
FUSED_QKV_TRAIN_MAX_SEQ = 384
# K1/K2 (and K5's forward) hold one head's whole K and V (forward, dq) or Q
# and dO (dkv) in shared memory, under 227 KB. The route never sends them
# more than 512; this is their guard at head dim 64, and K5's forward's.
FUSED_QKV_MAX_SEQ = 768
# ... by head dim: 80 lanes take 160 bytes a row, so K1's K and V of 768
# keys (240 KB) no longer fit; 512 covers K1's route (and K2's 384) and K5's.
RESIDENT_MAX_SEQ = {64: FUSED_QKV_MAX_SEQ, 80: 512}
# [B, H, S, D] attention: unite_tpu's grouped kernel K5 up to here, K6
# beyond; also the guard of K5's backward, whose dK/dV kernel holds a head's
# q and do (and at head dim 64 bf16(do/l)) in shared memory
GROUPED_MAX_SEQ = 512
# unite_tpu's _flash_qblock at its defaults: the packed route needs a
# multiple-of-8 query block in [64, 224] that divides S.
PACKED_QBLOCK_MIN, PACKED_QBLOCK_MAX = 64, 224


# ---------------------------------------------------------------- the route


def divisor_block(s: int, target: int) -> int:
    """Largest multiple-of-8 divisor of ``s`` that is <= ``target``, or 0
    (unite_tpu ``_divisor_block``)."""
    best = 0
    for b in range(8, min(target, s) + 1, 8):
        if s % b == 0:
            best = b
    return best


def packed_flash_ok(seq: int) -> bool:
    """unite_tpu ``_packed_flash_ok`` at the default block sizes: the query
    side of the packed kernels needs no padding."""
    return divisor_block(seq, PACKED_QBLOCK_MAX) >= PACKED_QBLOCK_MIN


def use_fused_qkv(seq: int, fwd_only: bool = False,
                  dim: Optional[int] = None) -> bool:
    """unite_tpu ``use_fused_qkv`` with its kernels on (``use_pallas``):
    whether the JAX models take the packed-qkv kernels (K1/K2 or K3/K4)
    rather than ``multi_head_attention``. ``dim`` is the model width, which
    JAX's lane-sliced blocks need to be a multiple of 128."""
    cap = FUSED_QKV_FWD_MAX_SEQ if fwd_only else FUSED_QKV_TRAIN_MAX_SEQ
    dim_ok = dim is None or dim % 128 == 0
    seq_ok = seq <= cap or (seq > FUSED_QKV_FWD_MAX_SEQ
                            and packed_flash_ok(seq))
    return seq_ok and dim_ok


def self_attention(qkv, heads: int, scale: float, dim: Optional[int] = None,
                   fwd_only: bool = False, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """The models' attention: qkv [B, S, 3*H*D] -> [B, S, H*D].

    K1/K2 or K3/K4 where ``use_fused_qkv`` accepts, else K5 (S <= 512) or
    K6 on strided [B, H, S, D] views of qkv, whose output is written in
    [B, S, H, D] memory so the head merge is a view. ``dim`` and
    ``fwd_only`` as in ``use_fused_qkv``: the ViT blocks pass their width
    and ``not self.training`` (JAX's ``deterministic``), CLIP passes no
    width and ``fwd_only=True``.

    ``dropout_rate`` > 0 in training (not ``fwd_only``) drops attention
    probabilities, drawn from ``generator``: that takes the plain
    ``attention_reference``, the JAX package's own routing of attention
    dropout to XLA (models/layers.py:173-186 -> ops/attention.py:1219-1229),
    as no kernel computes it. Evaluation keeps the kernels."""
    if dropout_rate > 0.0 and not fwd_only:
        q, k, v = _split_heads(qkv, heads)
        return _merge_heads(attention_reference(
            q, k, v, scale=scale, dropout_rate=dropout_rate,
            generator=generator))
    if use_fused_qkv(qkv.shape[1], fwd_only, dim):
        return fused_qkv_attention(qkv, heads, scale)
    q, k, v = _split_heads(qkv, heads)
    return _merge_heads(multi_head_attention(q, k, v, scale=scale))


# --------------------------------------------------------- plain versions


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Bernoulli(``keep``) draws of ``shape`` from ``generator``: the keep
    mask of every dropout and drop path of the port (JAX's
    ``jax.random.bernoulli`` sites)."""
    return torch.rand(shape, generator=generator, device=device) < keep


def attention_reference(q, k, v, *, scale=None, return_probs: bool = False,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None):
    """Plain attention, q/k/v [B, H, S, D]; fp32 scores and softmax, p cast
    to v's dtype for the p.v product (unite_tpu attention_xla). Dropout on
    the probabilities draws from ``generator``; ``return_probs`` also
    returns the fp32 probabilities before dropout."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    probs_out = probs
    if dropout_rate > 0.0:
        keep = keep_mask(probs.shape, 1.0 - dropout_rate, generator,
                         probs.device)
        probs = probs * keep / (1.0 - dropout_rate)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    return (out, probs_out) if return_probs else out


def _split_heads(qkv, heads):
    """[B, S, 3*H*D] -> q, k, v, each a [B, H, S, D] view of qkv (unbind:
    the gradient of the three views is one stack)."""
    b, s, thd = qkv.shape
    d = thd // (3 * heads)
    return [x.transpose(1, 2) for x in qkv.reshape(b, s, 3, heads, d).unbind(2)]


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _heads_of(x, heads):
    """[B, S, H*D] -> a [B, H, S, D] view."""
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def flash_reference(q, k, v, *, scale: float):
    """Plain K6 forward (``_fwd_kernel``, attention.py:148-171), which is
    also plain K1 and K3: raw fp32 scores, the exact row max,
    p = exp2((s - m)*c) rounded to the working type, l the row sum of the
    rounded p (``_pv_and_rowsum``), o = (p.v)/l. q/k/v [B, H, S, D] ->
    (o [B, H, S, D] in q's dtype, lse2 [B, H, S] fp32). Products take the
    working-type values in fp32, which is exact for bf16 operands with fp32
    accumulation."""
    dt = q.dtype
    s = q.float() @ k.float().transpose(-1, -2)  # the scale folds into exp2
    m = s.amax(dim=-1, keepdim=True)
    c = scale * INV_LN2
    p = torch.exp2((s - m) * c).to(dt).float()
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ v.float()) * (1.0 / l)
    return o.to(dt), (m * c + torch.log2(l)).squeeze(-1)


def _flash_dq_reference(q, k, v, o, do, lse, scale: float):
    """Plain dQ (``_bwd_dq_kernel`` :231-267, ``_packed_dq_kernel``
    :983-1011): delta = rowsum(do*o) in fp32, p from the lse in fp32,
    ds = p*(dp - delta)*scale rounded, dq = ds.k. Returns (dq, delta
    [B, H, S] fp32)."""
    dt = q.dtype
    kf, g = k.float(), do.float()
    delta = (g * o.float()).sum(-1, keepdim=True)
    p = torch.exp2((q.float() @ kf.transpose(-1, -2)) * (scale * INV_LN2)
                   - lse[..., None])
    dp = g @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta) * scale).to(dt).float()
    return (ds @ kf).to(dt), delta.squeeze(-1)


def _flash_dkv_reference(q, k, v, do, lse, delta, scale: float):
    """Plain dK/dV (``_bwd_dkv_kernel`` :270-304, ``_packed_dkv_kernel``
    :1014-1047): p^T from the lse rounded to the working type,
    dv = p^T.do, ds^T = p^T*(dp^T - delta)*scale rounded, dk = ds^T.q.
    Returns (dk, dv)."""
    dt = q.dtype
    qf, g = q.float(), do.float()
    pt = torch.exp2((k.float() @ qf.transpose(-1, -2)) * (scale * INV_LN2)
                    - lse[:, :, None, :]).to(dt).float()
    dv = pt @ g
    dpt = v.float() @ g.transpose(-1, -2)
    dst = (pt * (dpt - delta[:, :, None, :]) * scale).to(dt).float()
    return (dst @ qf).to(dt), dv.to(dt)


def flash_reference_bwd(q, k, v, o, lse, do, *, scale: float):
    """Plain K6 backward: (dq, dk, dv) from q/k/v, the forward's o and
    lse2, and the cotangent do, all [B, H, S, D]. The dQ side keeps p in
    fp32 and the dK/dV side rounds p^T, as the TPU kernels do (:263 against
    :289); delta comes from the dQ side, as ``_flash_bwd`` computes it
    outside the dK/dV kernel (:327)."""
    dq, delta = _flash_dq_reference(q, k, v, o, do, lse, scale)
    return (dq,) + _flash_dkv_reference(q, k, v, do, lse, delta, scale)


def grouped_reference(q, k, v, *, scale: float):
    """Plain K5 forward (``_grouped_fwd_kernel``, attention.py:441-464): raw
    fp32 scores, the exact row max m, e = exp2((s - m)*c) in fp32, l the row
    sum of e BEFORE rounding (plain K1/K6 sum the rounded p), and
    o = (bf16(e).v)/l. q/k/v [B, H, S, D] -> (o in q's dtype, m, l
    [B, H, S] fp32)."""
    dt = q.dtype
    s = q.float() @ k.float().transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2((s - m) * (scale * INV_LN2))
    l = e.sum(dim=-1, keepdim=True)
    o = (e.to(dt).float() @ v.float()) / l
    return o.to(dt), m.squeeze(-1), l.squeeze(-1)


def _grouped_e(q, k, m, l, scale: float):
    """e = exp2((q.k^T - m)*c) against the forward's row max, and 1/l."""
    s = q.float() @ k.float().transpose(-1, -2)
    return torch.exp2((s - m[..., None]) * (scale * INV_LN2)), 1.0 / l[..., None]


def _grouped_dq_reference(q, k, v, do, m, l, scale: float):
    """Plain K5 dQ side (``_grouped_bwd_kernel`` :475-502):
    delta = rowsum(e*dp)/l, ds = e*(dp - delta) unnormalised,
    dq = bf16(ds).k * (scale/l). Returns (dq, delta [B, H, S] fp32)."""
    dt = q.dtype
    e, inv_l = _grouped_e(q, k, m, l, scale)
    dp = do.float() @ v.float().transpose(-1, -2)
    delta = (e * dp).sum(dim=-1, keepdim=True) * inv_l
    ds = e * (dp - delta)
    dq = (ds.to(dt).float() @ k.float()) * (scale * inv_l)
    return dq.to(dt), delta.squeeze(-1)


def _grouped_dkv_reference(q, k, v, do, m, l, delta, scale: float):
    """Plain K5 dK/dV side (:486-506): dv = bf16(e)^T.bf16(do/l),
    dk = bf16(ds/l)^T.q * scale. Returns (dk, dv)."""
    dt = q.dtype
    e, inv_l = _grouped_e(q, k, m, l, scale)
    do_l = (do.float() * inv_l).to(dt).float()
    dv = e.to(dt).float().transpose(-1, -2) @ do_l
    ds = e * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    dk = ((ds * inv_l).to(dt).float().transpose(-1, -2) @ q.float()) * scale
    return dk.to(dt), dv.to(dt)


def grouped_reference_bwd(q, k, v, do, *, scale: float):
    """Plain K5 backward: (dq, dk, dv) from q/k/v and the cotangent do, all
    [B, H, S, D], recomputing the forward's m and l as the TPU kernel
    recomputes them."""
    _, m, l = grouped_reference(q, k, v, scale=scale)
    dq, delta = _grouped_dq_reference(q, k, v, do, m, l, scale)
    return (dq,) + _grouped_dkv_reference(q, k, v, do, m, l, delta, scale)


def qkv_attention_reference(qkv, heads: int, scale: float):
    """Plain K1 (attention.py:690-704), the arithmetic of plain K6 on the
    packed layout. Returns (out [B, S, H*D] in qkv's dtype, lse2 [B, H, S]
    fp32)."""
    o, lse = flash_reference(*_split_heads(qkv, heads), scale=scale)
    return _merge_heads(o), lse


def qkv_attention_reference_bwd(qkv, do, heads: int, scale: float):
    """Plain K2: the TPU kernel's backward math and rounding
    (attention.py:789-826). qkv [B, S, 3*H*D], do [B, S, H*D] -> dqkv."""
    dt = qkv.dtype
    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    g = _heads_of(do, heads).float()
    s = q @ k.transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2((s - m) * (scale * INV_LN2)).to(dt).float()
    inv_l = 1.0 / p.sum(dim=-1, keepdim=True)
    do_l = (g * inv_l).to(dt).float()
    dv = p.transpose(-1, -2) @ do_l
    dp = g @ v.transpose(-1, -2)
    t = p * dp
    delta2 = t.sum(dim=-1, keepdim=True) * (inv_l * inv_l)
    ds2 = (t * inv_l - p * delta2).to(dt).float()
    dq = (ds2 @ k) * scale
    dk = (ds2.transpose(-1, -2) @ q) * scale
    return torch.cat([_merge_heads(x.to(dt)) for x in (dq, dk, dv)], dim=-1)


def packed_flash_reference(qkv, heads: int, scale: float):
    """Plain K3 (attention.py:913-934): the same function as plain K1. The
    TPU kernel blocks the queries but keeps every key in view, so the row
    max is the exact global one and p = exp2((s - m)*c) is rounded against
    it. Returns (out [B, S, H*D], lse2 [B, H, S] fp32)."""
    return qkv_attention_reference(qkv, heads, scale)


def _packed_dq_reference(qkv, out, lse, do, heads: int, scale: float):
    """Plain K4a (``_packed_dq_kernel``, :983-1011, delta as
    ``_packed_flash_bwd`` :1062-1063). Returns (dq [B, S, H*D], delta
    [B, H, S] fp32)."""
    q, k, v = _split_heads(qkv, heads)
    dq, delta = _flash_dq_reference(q, k, v, _heads_of(out, heads),
                                    _heads_of(do, heads), lse, scale)
    return _merge_heads(dq), delta


def _packed_dkv_reference(qkv, lse, delta, do, heads: int, scale: float):
    """Plain K4b (``_packed_dkv_kernel``, :1014-1047). Returns (dk, dv),
    each [B, S, H*D]."""
    dk, dv = _flash_dkv_reference(*_split_heads(qkv, heads),
                                  _heads_of(do, heads), lse, delta, scale)
    return _merge_heads(dk), _merge_heads(dv)


def packed_flash_reference_bwd(qkv, out, lse, do, heads: int, scale: float):
    """Plain K4: dqkv [B, S, 3*H*D] from qkv, K3's out and lse2 and the
    cotangent do (the arithmetic of plain K6's backward)."""
    dq, delta = _packed_dq_reference(qkv, out, lse, do, heads, scale)
    dk, dv = _packed_dkv_reference(qkv, lse, delta, do, heads, scale)
    return torch.cat([dq, dk, dv], dim=-1)


def _need_fp32(*tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the fp32 attention kernels take float32, got "
                            f"{t.dtype}")


def attention_fp32_reference(q, k, v, scale: float):
    """Plain version of the fp32 kernels' forward (csrc/attn_fp32.cu):
    q/k/v [B, H, S, D] fp32 -> (o, lse2 [B, H, S]). Raw scores s = q.k^T,
    the exact row max m over all keys, p = exp2((s - m)*c) kept in fp32,
    l = rowsum(p), o = (p.v) * (1/l), lse2 = m*c + log2(l). This is plain
    K6 (``flash_reference``), whose rounding of p is an identity at fp32;
    at fp32 plain K1, K3 and K5 compute the same function up to summation
    order."""
    _need_fp32(q, k, v)
    return flash_reference(q, k, v, scale=scale)


def attention_fp32_reference_bwd(q, k, v, o, lse, do, scale: float):
    """Plain version of the fp32 kernels' backward: (dq, dk, dv) from q/k/v,
    the forward's o and lse2 and the cotangent do, all fp32:
    delta = rowsum(do*o), p = exp2(s*c - lse2), ds = p*(do.v^T - delta)*scale,
    dq = ds.k, dk = ds^T.q, dv = p^T.do (plain K6's backward, whose
    roundings are identities at fp32)."""
    _need_fp32(q, k, v, o, do)
    return flash_reference_bwd(q, k, v, o, lse, do, scale=scale)


# ------------------------------------------------------------ launching


def _dtype_ok(dtype):
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"attention kernels take bf16 (wgmma) or float32 "
                        f"(SIMT) on CUDA, got {dtype}")


def _check_cuda(qkv, heads, **aux) -> int:
    """What K1/K2 need: bf16 or fp32 qkv of a head dim in ``HEAD_DIMS``, and
    each auxiliary tensor (out, do, lse, delta, dqkv) of its shape and type,
    contiguous, on qkv's device. K3/K4 check the same before they take
    strided views. Returns the head dim."""
    _dtype_ok(qkv.dtype)
    b, s, thd = qkv.shape
    d = thd // (3 * heads)
    if thd != 3 * heads * d or d not in HEAD_DIMS:
        raise ValueError(
            f"attention kernels K1-K4 take head dims {HEAD_DIMS}: width "
            f"{thd} with {heads} heads is head dim {thd / (3 * heads):g}")
    want = {"out": ((b, s, thd // 3), qkv.dtype),
            "do": ((b, s, thd // 3), qkv.dtype),
            "dqkv": ((b, s, thd), qkv.dtype),
            "lse": ((b, heads, s), torch.float32),
            "delta": ((b, heads, s), torch.float32)}
    for t in [qkv] + list(aux.values()):
        if not t.is_contiguous() or t.device != qkv.device:
            raise ValueError("attention kernels take contiguous tensors on "
                             "one device")
    for name, t in aux.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the kernel "
                             f"takes {shape} {dtype}")
    return d


def _check_resident(qkv, d: int):
    s, cap = qkv.shape[1], RESIDENT_MAX_SEQ[d]
    if s > cap:
        raise ValueError(
            f"sequence {s} > {cap}: one head's K/V of head dim {d} no longer "
            "fit in shared memory for K1/K2; sequences longer than "
            f"{FUSED_QKV_FWD_MAX_SEQ} take the flash kernels K3/K4 or K6 "
            "(self_attention routes them there)")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=256)
def _strides_arg(strides: tuple):
    """The strides as the C entry points take them (cached: a step passes
    the same few layouts over and over)."""
    return (ctypes.c_longlong * len(strides))(*strides)


def _view_head_dim(q) -> int:
    """The head dim of a [B, H, S, D] tensor bound for K5 or K6 on CUDA,
    which must be one of ``HEAD_DIMS``."""
    if q.dim() != 4 or q.shape[3] not in HEAD_DIMS:
        raise ValueError(
            f"attention kernels K5 and K6 take [B, H, S, D] at head dims "
            f"{HEAD_DIMS} on CUDA, got {tuple(q.shape)}")
    return q.shape[3]


def _view_args(*views):
    """(data pointers, strides) of [B, H, S, D] views of one dtype (bf16 or
    fp32) for the C entry points of K5, K6 and the fp32 kernels, after
    checking that all share one shape (D in ``HEAD_DIMS``) and device and
    that the kernels take each as it is."""
    shape, dev = views[0].shape, views[0].device
    _view_head_dim(views[0])
    _dtype_ok(views[0].dtype)
    ptrs, strides = [], []
    for t in views:
        if t.dtype != views[0].dtype:
            raise TypeError(f"attention kernels take one dtype, got "
                            f"{t.dtype} beside {views[0].dtype}")
        st, ptr = t.stride(), t.data_ptr()
        if (t.shape != shape or t.device != dev or st[3] != 1 or ptr % 16
                or any(x % 8 for n, x in zip(shape[:3], st) if n > 1)):
            raise ValueError(
                "attention kernels K5 and K6 take [B, H, S, D] views of one "
                "shape on one device, with contiguous head lanes and 16-byte "
                f"aligned rows: shape {tuple(t.shape)} strides {st} on "
                f"{t.device}, against {tuple(shape)} on {dev}")
        ptrs.append(ptr)
        strides += st[:3]
    return ptrs, _strides_arg(tuple(strides))


def _lanes(t, heads: int, d: int, parts):
    """(data pointers, strides) of lane slices ``parts`` of a contiguous
    [B, S, n*H*D] tensor (qkv, out, do, dqkv) as [B, H, S, D] views,
    computed from its shape: the packed route makes no view objects."""
    _, s, width = t.shape
    hd, base = heads * d, t.data_ptr()
    return ([base + t.element_size() * i * hd for i in parts],
            (s * width, d, width) * len(parts))


def _packed_args(heads: int, d: int, *tensor_parts):
    """Pointers and strides of the packed kernels' views: pairs of a
    [B, S, n*H*D] tensor and its lane slices, in the C entry's order."""
    ptrs, strides = [], ()
    for t, parts in tensor_parts:
        p, st = _lanes(t, heads, d, parts)
        ptrs += p
        strides += st
    return ptrs, _strides_arg(strides)


def _stats(like, *stats):
    b, h, s, _ = like.shape
    for t in stats:
        if (tuple(t.shape) != (b, h, s) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != like.device):
            raise ValueError(f"row statistic {tuple(t.shape)} {t.dtype}: the "
                             f"kernels take contiguous fp32 {(b, h, s)}")


def _empty_like_rows(x):
    """An output [B, H, S, D] laid out as ``x`` is: [B, S, H, D] memory
    when x's heads share its rows (a view of the qkv projection), so the
    head merge after it is free, else contiguous."""
    b, h, s, d = x.shape
    if h > 1 and x.stride(1) < x.stride(2):
        return torch.empty((b, s, h, d), dtype=x.dtype,
                           device=x.device).transpose(1, 2)
    return torch.empty((b, h, s, d), dtype=x.dtype, device=x.device)


def _launch_fwd(ptrs, strides, lse, dims, scale: float, stream):
    """The strided forward kernel (K3 or K6, csrc/flash_fwd_wgmma.cu):
    pointers of q, k, v, o; ``dims`` (B, H, S, D)."""
    b, h, s, d = dims
    err = _build.load("flash_fwd_wgmma").unite_flash_fwd(
        *ptrs, lse.data_ptr() if lse is not None else None, strides, b, s, h,
        d, scale * INV_LN2, stream)
    _build.check(err, "flash_fwd")


def _launch_dq(ptrs, strides, lse, delta, dims, scale: float, stream):
    """The strided dQ kernel (K4a or K6 dq, csrc/flash_bwd_wgmma.cu):
    pointers of q, k, v, o, do, dq; ``dims`` (B, H, S, D)."""
    b, h, s, d = dims
    q, k, v, o, do, dq = ptrs
    err = _build.load("flash_bwd_wgmma").unite_flash_dq(
        q, k, v, o, do, lse.data_ptr(), delta.data_ptr(), dq, strides, b, s,
        h, d, scale * INV_LN2, scale, stream)
    _build.check(err, "flash_dq")


def _launch_dkv(ptrs, strides, lse, delta, dims, scale: float, stream):
    """The strided dK/dV kernel (K4b or K6 dkv, csrc/flash_bwd_wgmma.cu):
    pointers of q, k, v, do, dk, dv; ``dims`` (B, H, S, D)."""
    b, h, s, d = dims
    q, k, v, do, dk, dv = ptrs
    err = _build.load("flash_bwd_wgmma").unite_flash_dkv(
        q, k, v, do, lse.data_ptr(), delta.data_ptr(), dk, dv, strides, b, s,
        h, d, scale * INV_LN2, scale, stream)
    _build.check(err, "flash_dkv")


# ------------------------------------------------- the fp32 kernels


def _count(wrapper, route: str) -> None:
    wrapper.launches += 1
    wrapper.by_route[route] += 1


def fp32_attn_fwd(q, k, v, scale: float, with_lse: bool = False, o=None,
                  route: str = "direct"):
    """The fp32 forward (csrc/attn_fp32.cu ``unite_fp32_attn_fwd``):
    q/k/v [B, H, S, D] fp32 views -> (o, lse2 [B, H, S] or None), any S.
    ``o`` is a view to write (the packed routes' [B, S, H*D] lanes), else
    one laid out as q is made; ``route`` is the TPU kernel the launch
    stands in for (``.by_route``). CPU tensors take
    ``attention_fp32_reference``."""
    _need_fp32(q, k, v)
    if q.device.type == "cpu":
        out, lse = attention_fp32_reference(q, k, v, scale)
        if o is not None:
            out = o.copy_(out)
        return out, (lse if with_lse else None)
    o = _empty_like_rows(q) if o is None else o
    ptrs, strides = _view_args(q, k, v, o)
    b, h, s, d = q.shape
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _build.load("attn_fp32").unite_fp32_attn_fwd(
        *ptrs, lse.data_ptr() if lse is not None else None, strides, b, s, h,
        d, scale * INV_LN2, _stream(q))
    _build.check(err, "fp32_attn_fwd")
    _count(fp32_attn_fwd, route)
    return o, lse


def fp32_attn_dq(q, k, v, o, do, lse, dq, delta, scale: float,
                 route: str = "direct"):
    """The fp32 dQ (``unite_fp32_attn_dq``): writes dq into ``dq`` and
    rowsum(do*o) into ``delta`` [B, H, S] fp32, from the forward's o and
    lse2. CPU tensors take the plain version's dQ side."""
    _need_fp32(q, k, v, o, do)
    if q.device.type == "cpu":
        g, dl = _flash_dq_reference(q, k, v, o, do, lse, scale)
        dq.copy_(g)
        delta.copy_(dl)
        return
    ptrs, strides = _view_args(q, k, v, o, do, dq)
    _stats(q, lse, delta)
    b, h, s, d = q.shape
    err = _build.load("attn_fp32").unite_fp32_attn_dq(
        *ptrs[:5], lse.data_ptr(), delta.data_ptr(), ptrs[5], strides, b, s,
        h, d, scale * INV_LN2, scale, _stream(q))
    _build.check(err, "fp32_attn_dq")
    _count(fp32_attn_dq, route)


def fp32_attn_dkv(q, k, v, do, lse, delta, dk, dv, scale: float,
                  route: str = "direct"):
    """The fp32 dK/dV (``unite_fp32_attn_dkv``): writes dk and dv from the
    forward's lse2 and the dQ entry's delta. CPU tensors take the plain
    version's dK/dV side."""
    _need_fp32(q, k, v, do)
    if q.device.type == "cpu":
        gk, gv = _flash_dkv_reference(q, k, v, do, lse, delta, scale)
        dk.copy_(gk)
        dv.copy_(gv)
        return
    ptrs, strides = _view_args(q, k, v, do, dk, dv)
    _stats(q, lse, delta)
    b, h, s, d = q.shape
    err = _build.load("attn_fp32").unite_fp32_attn_dkv(
        *ptrs[:4], lse.data_ptr(), delta.data_ptr(), *ptrs[4:], strides, b, s,
        h, d, scale * INV_LN2, scale, _stream(q))
    _build.check(err, "fp32_attn_dkv")
    _count(fp32_attn_dkv, route)


for _w in (fp32_attn_fwd, fp32_attn_dq, fp32_attn_dkv):
    _w.launches, _w.by_route = 0, Counter()


def _packed_fp32_fwd(qkv, heads: int, scale: float, with_lse: bool,
                     route: str):
    """K1 or K3 at fp32: the fp32 forward on [B, H, S, D] views of qkv's
    lane slices, writing out [B, S, H*D]."""
    b, s, thd = qkv.shape
    out = torch.empty((b, s, thd // 3), dtype=qkv.dtype, device=qkv.device)
    _, lse = fp32_attn_fwd(*_split_heads(qkv, heads), scale, with_lse,
                           o=_heads_of(out, heads), route=route)
    return out, lse


def _packed_fp32_dq(qkv, out, lse, do, dqkv, delta, heads: int,
                    scale: float, route: str):
    """K2's or K4a's dQ side at fp32: dq into the q lanes of ``dqkv``."""
    fp32_attn_dq(*_split_heads(qkv, heads), _heads_of(out, heads),
                 _heads_of(do, heads), lse, _split_heads(dqkv, heads)[0],
                 delta, scale, route=route)


def _packed_fp32_dkv(qkv, do, lse, delta, dqkv, heads: int, scale: float,
                     route: str):
    """K2's or K4b's dK/dV side at fp32: dk and dv into the k and v lanes
    of ``dqkv``."""
    fp32_attn_dkv(*_split_heads(qkv, heads), _heads_of(do, heads), lse,
                  delta, *_split_heads(dqkv, heads)[1:], scale, route=route)


# ------------------------------------------------------------ K1 and K2


def _fwd_outputs(qkv, heads, with_lse):
    b, s, thd = qkv.shape
    out = torch.empty((b, s, thd // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    return out, lse


def fused_qkv_fwd(qkv, heads: int, scale: float, with_lse: bool = False):
    """K1: qkv [B, S, 3*H*D] -> (out [B, S, H*D], lse2 [B, H, S] or None).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if qkv.device.type == "cpu":
        out, lse = qkv_attention_reference(qkv, heads, scale)
        return out, (lse if with_lse else None)
    d = _check_cuda(qkv, heads)
    if qkv.dtype == torch.float32:
        return _packed_fp32_fwd(qkv, heads, scale, with_lse, "K1")
    _check_resident(qkv, d)
    out, lse = _fwd_outputs(qkv, heads, with_lse)
    ptrs, strides = _packed_args(heads, d, (qkv, (0, 1, 2)), (out, (0,)))
    err = _build.load("short_attn_wgmma").unite_short_qkv_fwd(
        *ptrs, lse.data_ptr() if with_lse else None, strides, qkv.shape[0],
        qkv.shape[1], heads, d, scale * INV_LN2, _stream(qkv))
    _build.check(err, "fused_qkv_fwd")
    fused_qkv_fwd.launches += 1
    fused_qkv_fwd.by_shape[tuple(qkv.shape[:2])] += 1
    return out, lse


fused_qkv_fwd.launches = 0
fused_qkv_fwd.by_shape = Counter()


def fused_qkv_bwd(qkv, out, lse, do, heads: int, scale: float):
    """K2: dqkv [B, S, 3*H*D] from qkv, the forward's out and lse2, and the
    cotangent do. CPU tensors take the plain version (which recomputes the
    softmax as the TPU kernel does and needs no out/lse); CUDA tensors
    launch csrc/short_bwd_wgmma.cu's dq then dk/dv kernel on the lane
    slices of qkv, out, do and dqkv."""
    if qkv.device.type == "cpu":
        return qkv_attention_reference_bwd(qkv, do, heads, scale)
    d = _check_cuda(qkv, heads, out=out, lse=lse, do=do)
    b, s, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device)
    if qkv.dtype == torch.float32:
        _packed_fp32_dq(qkv, out, lse, do, dqkv, delta, heads, scale, "K2")
        _packed_fp32_dkv(qkv, do, lse, delta, dqkv, heads, scale, "K2")
        return dqkv
    _check_resident(qkv, d)
    ptrs, strides = _packed_args(heads, d, (qkv, (0, 1, 2)), (out, (0,)),
                                 (do, (0,)), (dqkv, (0, 1, 2)))
    err = _build.load("short_bwd_wgmma").unite_short_qkv_bwd(
        *ptrs, lse.data_ptr(), delta.data_ptr(), strides, b, s, heads, d,
        scale * INV_LN2, scale, _stream(qkv))
    _build.check(err, "fused_qkv_bwd")
    fused_qkv_bwd.launches += 1
    return dqkv


fused_qkv_bwd.launches = 0


# ------------------------------------------------------------ K3 and K4


def packed_flash_fwd(qkv, heads: int, scale: float, with_lse: bool = False):
    """K3: qkv [B, S, 3*H*D] -> (out [B, S, H*D], lse2 [B, H, S] or None),
    any S. CPU tensors take the plain version; CUDA tensors launch the
    strided forward kernel on the lane slices of qkv and out."""
    if qkv.device.type == "cpu":
        out, lse = packed_flash_reference(qkv, heads, scale)
        return out, (lse if with_lse else None)
    d = _check_cuda(qkv, heads)
    if qkv.dtype == torch.float32:
        return _packed_fp32_fwd(qkv, heads, scale, with_lse, "K3")
    out, lse = _fwd_outputs(qkv, heads, with_lse)
    ptrs, strides = _packed_args(heads, d, (qkv, (0, 1, 2)), (out, (0,)))
    _launch_fwd(ptrs, strides, lse, (qkv.shape[0], heads, qkv.shape[1], d),
                scale, _stream(qkv))
    packed_flash_fwd.launches += 1
    packed_flash_fwd.by_shape[tuple(qkv.shape[:2])] += 1
    if with_lse:
        packed_flash_fwd.lse_launches += 1
    return out, lse


packed_flash_fwd.launches = packed_flash_fwd.lse_launches = 0
packed_flash_fwd.by_shape = Counter()


def packed_flash_dq(qkv, out, lse, do, dqkv, delta, heads: int,
                    scale: float):
    """K4a: writes dq into the q lanes of ``dqkv`` [B, S, 3*H*D] and
    rowsum(do*o) into ``delta`` [B, H, S] fp32."""
    hd = qkv.shape[2] // 3
    if qkv.device.type == "cpu":
        dq, dl = _packed_dq_reference(qkv, out, lse, do, heads, scale)
        dqkv[..., :hd] = dq
        delta.copy_(dl)
        return
    d = _check_cuda(qkv, heads, out=out, lse=lse, do=do, dqkv=dqkv,
                    delta=delta)
    if qkv.dtype == torch.float32:
        _packed_fp32_dq(qkv, out, lse, do, dqkv, delta, heads, scale, "K4")
        return
    ptrs, strides = _packed_args(heads, d, (qkv, (0, 1, 2)), (out, (0,)),
                                 (do, (0,)), (dqkv, (0,)))
    _launch_dq(ptrs, strides, lse, delta,
               (qkv.shape[0], heads, qkv.shape[1], d), scale, _stream(qkv))
    packed_flash_dq.launches += 1


packed_flash_dq.launches = 0


def packed_flash_dkv(qkv, do, lse, delta, dqkv, heads: int, scale: float):
    """K4b: writes dk and dv into the k and v lanes of ``dqkv``, from K3's
    lse2 and K4a's delta."""
    hd = qkv.shape[2] // 3
    if qkv.device.type == "cpu":
        dk, dv = _packed_dkv_reference(qkv, lse, delta, do, heads, scale)
        dqkv[..., hd:2 * hd] = dk
        dqkv[..., 2 * hd:] = dv
        return
    d = _check_cuda(qkv, heads, lse=lse, delta=delta, do=do, dqkv=dqkv)
    if qkv.dtype == torch.float32:
        _packed_fp32_dkv(qkv, do, lse, delta, dqkv, heads, scale, "K4")
        return
    ptrs, strides = _packed_args(heads, d, (qkv, (0, 1, 2)), (do, (0,)),
                                 (dqkv, (1, 2)))
    _launch_dkv(ptrs, strides, lse, delta,
                (qkv.shape[0], heads, qkv.shape[1], d), scale, _stream(qkv))
    packed_flash_dkv.launches += 1


packed_flash_dkv.launches = 0


def packed_flash_bwd(qkv, out, lse, do, heads: int, scale: float):
    """K4: dqkv [B, S, 3*H*D] through K4a then K4b, both writing straight
    into the packed gradient (no concatenation)."""
    b, s, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device)
    packed_flash_dq(qkv, out, lse, do, dqkv, delta, heads, scale)
    packed_flash_dkv(qkv, do, lse, delta, dqkv, heads, scale)
    return dqkv


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale):
        train = ctx.needs_input_grad[0]
        ctx.packed = qkv.shape[1] > FUSED_QKV_FWD_MAX_SEQ
        fwd = packed_flash_fwd if ctx.packed else fused_qkv_fwd
        out, lse = fwd(qkv, heads, scale, with_lse=train)
        if train:
            ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        bwd = packed_flash_bwd if ctx.packed else fused_qkv_bwd
        return bwd(qkv, out, lse, do.contiguous(), ctx.heads,
                   ctx.scale), None, None


def fused_qkv_attention(qkv, heads: int, scale: float):
    """qkv [B, S, 3*H*D] (natural Linear layout) -> [B, S, H*D], through
    K1/K2 up to 512 tokens and K3/K4 beyond (the kernels take any S; the
    models send them only what ``use_fused_qkv`` accepts)."""
    return _FusedQKVAttention.apply(qkv, heads, scale)


# ------------------------------------------------------------------- K6


def flash_fwd(q, k, v, scale: float, with_lse: bool = False):
    """K6 forward: q/k/v [B, H, S, D] -> (o [B, H, S, D] laid out as q,
    lse2 [B, H, S] or None), any S, contiguous tensors or strided views.
    CPU tensors take the plain version (any D); CUDA tensors launch the
    kernel, at D in ``HEAD_DIMS``."""
    if q.device.type == "cpu":
        o, lse = flash_reference(q, k, v, scale=scale)
        return o, (lse if with_lse else None)
    if q.dtype == torch.float32:
        return fp32_attn_fwd(q, k, v, scale, with_lse, route="K6")
    o = _empty_like_rows(q)
    ptrs, strides = _view_args(q, k, v, o)
    b, h, s, _ = q.shape
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch_fwd(ptrs, strides, lse, q.shape, scale, _stream(q))
    flash_fwd.launches += 1
    flash_fwd.by_shape[(b, s)] += 1
    if with_lse:
        flash_fwd.lse_launches += 1
    return o, lse


flash_fwd.launches = flash_fwd.lse_launches = 0
flash_fwd.by_shape = Counter()


def flash_dq(q, k, v, o, do, lse, dq, delta, scale: float):
    """K6 dQ: writes dq into ``dq`` and rowsum(do*o) into ``delta``
    [B, H, S] fp32."""
    if q.device.type == "cpu":
        g, dl = _flash_dq_reference(q, k, v, o, do, lse, scale)
        dq.copy_(g)
        delta.copy_(dl)
        return
    if q.dtype == torch.float32:
        fp32_attn_dq(q, k, v, o, do, lse, dq, delta, scale, route="K6")
        return
    ptrs, strides = _view_args(q, k, v, o, do, dq)
    _stats(q, lse, delta)
    _launch_dq(ptrs, strides, lse, delta, q.shape, scale, _stream(q))
    flash_dq.launches += 1


flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, delta, dk, dv, scale: float):
    """K6 dK/dV: writes dk and dv from the forward's lse2 and the dQ
    kernel's delta."""
    if q.device.type == "cpu":
        gk, gv = _flash_dkv_reference(q, k, v, do, lse, delta, scale)
        dk.copy_(gk)
        dv.copy_(gv)
        return
    if q.dtype == torch.float32:
        fp32_attn_dkv(q, k, v, do, lse, delta, dk, dv, scale, route="K6")
        return
    ptrs, strides = _view_args(q, k, v, do, dk, dv)
    _stats(q, lse, delta)
    _launch_dkv(ptrs, strides, lse, delta, q.shape, scale, _stream(q))
    flash_dkv.launches += 1


flash_dkv.launches = 0


def flash_bwd(q, k, v, o, lse, do, scale: float):
    """K6 backward: (dq, dk, dv), each laid out as its input, through the
    dQ kernel then the dK/dV kernel."""
    dq, dk, dv = (_empty_like_rows(x) for x in (q, k, v))
    b, h, s, _ = q.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    flash_dq(q, k, v, o, do, lse, dq, delta, scale)
    flash_dkv(q, k, v, do, lse, delta, dk, dv, scale)
    return dq, dk, dv


# ------------------------------------------------------------------- K5


def grouped_fwd(q, k, v, scale: float, with_stats: bool = False):
    """K5 forward: q/k/v [B, H, S, D] -> (o laid out as q, the statistics
    the backward takes or None), contiguous tensors or strided views. CPU
    tensors take the plain version (any D), whose statistics are (m, l)
    [B, H, S] fp32; bf16 CUDA tensors launch the kernel, at D in
    ``HEAD_DIMS`` and up to ``RESIDENT_MAX_SEQ[D]`` keys, with (m, l) too;
    fp32 CUDA tensors launch the fp32 forward, any S, whose backward takes
    (o, lse2) instead."""
    if q.device.type == "cpu":
        o, m, l = grouped_reference(q, k, v, scale=scale)
        return o, ((m, l) if with_stats else None)
    if q.dtype == torch.float32:
        o, lse = fp32_attn_fwd(q, k, v, scale, with_stats, route="K5")
        return o, ((o, lse) if with_stats else None)
    d = _view_head_dim(q)
    if q.shape[2] > RESIDENT_MAX_SEQ[d]:
        raise ValueError(
            f"sequence {q.shape[2]} > {RESIDENT_MAX_SEQ[d]}: one head's K/V "
            f"of head dim {d} no longer fit in shared memory for K5; longer "
            "sequences take K6 (multi_head_attention routes them there)")
    o = _empty_like_rows(q)
    ptrs, strides = _view_args(q, k, v, o)
    b, h, s, _ = q.shape
    stats = (tuple(torch.empty((b, h, s), dtype=torch.float32,
                               device=q.device) for _ in range(2))
             if with_stats else None)
    err = _build.load("short_attn_wgmma").unite_short_grouped_fwd(
        *ptrs, *((t.data_ptr() for t in stats) if stats else (None, None)),
        strides, b, s, h, d, scale * INV_LN2, _stream(q))
    _build.check(err, "grouped_fwd")
    grouped_fwd.launches += 1
    return o, stats


grouped_fwd.launches = 0


def _check_grouped_bwd(q):
    if q.shape[2] > GROUPED_MAX_SEQ:
        raise ValueError(
            f"sequence {q.shape[2]} > {GROUPED_MAX_SEQ}: a head's q and do "
            "no longer fit in shared memory for K5's backward; longer "
            "sequences take K6 (multi_head_attention routes them there)")


def grouped_dq(q, k, v, do, m, l, dq, delta, scale: float):
    """K5 dQ: writes dq into ``dq`` and rowsum(e*dp)/l into ``delta``
    [B, H, S] fp32, from the forward's statistics ``m, l``
    (``grouped_fwd``'s): csrc/short_bwd_wgmma.cu's dq kernel on bf16 CUDA
    tensors, the fp32 dQ on fp32 ones, where ``m, l`` are o and lse2."""
    if q.device.type == "cpu":
        g, dl = _grouped_dq_reference(q, k, v, do, m, l, scale)
        dq.copy_(g)
        delta.copy_(dl)
        return
    if q.dtype == torch.float32:
        fp32_attn_dq(q, k, v, m, do, l, dq, delta, scale, route="K5")
        return
    _check_grouped_bwd(q)
    ptrs, strides = _view_args(q, k, v, do, dq)
    _stats(q, m, l, delta)
    b, h, s, d = q.shape
    err = _build.load("short_bwd_wgmma").unite_short_grouped_dq(
        *ptrs[:4], m.data_ptr(), l.data_ptr(), delta.data_ptr(), ptrs[4],
        strides, b, s, h, d, scale * INV_LN2, scale, _stream(q))
    _build.check(err, "grouped_dq")
    grouped_dq.launches += 1


grouped_dq.launches = 0


def grouped_dkv(q, k, v, do, m, l, delta, dk, dv, scale: float):
    """K5 dK/dV: writes dk and dv from the forward's statistics ``m, l``
    and the dQ kernel's delta (csrc/short_bwd_wgmma.cu's dk/dv kernel on
    bf16 CUDA tensors, the fp32 dK/dV on fp32 ones, from lse2 ``l``)."""
    if q.device.type == "cpu":
        gk, gv = _grouped_dkv_reference(q, k, v, do, m, l, delta, scale)
        dk.copy_(gk)
        dv.copy_(gv)
        return
    if q.dtype == torch.float32:
        fp32_attn_dkv(q, k, v, do, l, delta, dk, dv, scale, route="K5")
        return
    _check_grouped_bwd(q)
    ptrs, strides = _view_args(q, k, v, do, dk, dv)
    _stats(q, m, l, delta)
    b, h, s, d = q.shape
    err = _build.load("short_bwd_wgmma").unite_short_grouped_dkv(
        *ptrs[:4], m.data_ptr(), l.data_ptr(), delta.data_ptr(), *ptrs[4:],
        strides, b, s, h, d, scale * INV_LN2, scale, _stream(q))
    _build.check(err, "grouped_dkv")
    grouped_dkv.launches += 1


grouped_dkv.launches = 0


def grouped_bwd(q, k, v, do, m, l, scale: float):
    """K5 backward: (dq, dk, dv), each laid out as its input, through the
    dQ kernel then the dK/dV kernel, from ``grouped_fwd``'s statistics."""
    dq, dk, dv = (_empty_like_rows(x) for x in (q, k, v))
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    grouped_dq(q, k, v, do, m, l, dq, delta, scale)
    grouped_dkv(q, k, v, do, m, l, delta, dk, dv, scale)
    return dq, dk, dv


def _kernel_layout(t):
    """A cotangent as the flash kernels take it: ``t`` itself where its
    head lanes are contiguous and its rows 16-byte aligned at distinct
    addresses, else a contiguous copy (a broadcast gradient, whose stride
    0 passes the 16-byte test; a misaligned slice; rows of a length that
    is not a multiple of 16 bytes)."""
    if t.device.type == "cpu" or (
            t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st % 8 == 0
                    for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)):
        return t
    return t.contiguous()


class _GroupedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        train = any(ctx.needs_input_grad[:3])
        o, stats = grouped_fwd(q, k, v, scale, with_stats=train)
        if train:
            ctx.save_for_backward(q, k, v, *stats)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, m, l = ctx.saved_tensors
        return grouped_bwd(q, k, v, _kernel_layout(do), m, l,
                           ctx.scale) + (None,)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        train = any(ctx.needs_input_grad[:3])
        o, lse = flash_fwd(q, k, v, scale, with_lse=train)
        if train:
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, _kernel_layout(do),
                         ctx.scale) + (None,)


def multi_head_attention(q, k, v, *, scale=None, return_probs: bool = False,
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         deterministic: bool = True):
    """q, k, v [B, H, S, D] -> [B, H, S, D] (unite_tpu
    ``multi_head_attention`` without its TPU knobs).

    Probabilities or dropout take the plain ``attention_reference``, as
    ``attention_xla`` serves them in JAX. Otherwise S <= 512 takes K5 and
    longer sequences K6; CPU tensors take their plain versions."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    drop = dropout_rate if not deterministic else 0.0
    if return_probs or drop > 0.0:
        return attention_reference(q, k, v, scale=scale,
                                   return_probs=return_probs,
                                   dropout_rate=drop, generator=generator)
    if q.shape[2] <= GROUPED_MAX_SEQ:
        return _GroupedAttention.apply(q, k, v, scale)
    return _FlashAttention.apply(q, k, v, scale)
