"""Multi-head attention: plain PyTorch references and the fused-qkv kernels.

Counterpart of unite_tpu/ops/attention.py. The stage-1 path runs attention
only through ``fused_qkv_attention``: it consumes the qkv projection's
natural [B, S, 3*H*D] layout and returns [B, S, H*D], with the head split
and merge done inside the kernels (csrc/fused_qkv_fwd.cu, K1, and
csrc/fused_qkv_bwd.cu, K2). Beside each kernel is its plain version, with
the TPU kernel's math and rounding points; a wrapper uses it only for a
tensor on the CPU. A CUDA tensor launches the kernel or raises.

Both kernels fold the softmax scale into a base-2 exponent,
exp(s*scale - m*scale) == exp2((s - m)*c) with c = scale*log2(e), and the
saved row statistic is the base-2 log-sum-exp of the scaled scores,
lse2 = m*c + log2(l).
"""

from __future__ import annotations

import math

import torch

from unite_torch.ops import _build

INV_LN2 = 1.4426950408889634  # log2(e)
HEAD_DIM = 64
# Shared memory holds one head's whole K and V (forward, dq) or Q and dO
# (dkv): 2*S*72*2 bytes, plus 8*S for the row statistics, under 227 KB.
FUSED_QKV_MAX_SEQ = 768


def attention_reference(q, k, v, *, scale=None):
    """Plain attention, q/k/v [B, H, S, D]; fp32 scores and softmax, p cast
    to v's dtype for the p.v product (unite_tpu attention_xla)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _split_heads(qkv, heads):
    b, s, thd = qkv.shape
    d = thd // (3 * heads)
    x = qkv.reshape(b, s, 3, heads, d)
    return [x[:, :, i].transpose(1, 2) for i in range(3)]  # each [B, H, S, D]


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def qkv_attention_reference(qkv, heads: int, scale: float):
    """Plain K1: the TPU kernel's math and rounding (attention.py:690-704).

    Returns (out [B, S, H*D] in qkv's dtype, lse2 [B, H, S] fp32). Products
    take the working-type values in fp32, which is exact for bf16 operands
    with fp32 accumulation."""
    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    s = q @ k.transpose(-1, -2)  # raw scores; the scale folds into exp2
    m = s.amax(dim=-1, keepdim=True)
    c = scale * INV_LN2
    p = torch.exp2((s - m) * c).to(qkv.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ v) * (1.0 / l)
    lse2 = (m * c + torch.log2(l)).squeeze(-1)
    return _merge_heads(o.to(qkv.dtype)), lse2


def qkv_attention_reference_bwd(qkv, do, heads: int, scale: float):
    """Plain K2: the TPU kernel's backward math and rounding
    (attention.py:789-826). qkv [B, S, 3*H*D], do [B, S, H*D] -> dqkv."""
    dt = qkv.dtype
    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    b, h, s_len, d = q.shape
    g = do.reshape(b, s_len, h, d).transpose(1, 2).float()
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


def _check_cuda(qkv, heads, *others):
    b, s, thd = qkv.shape
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"fused-qkv kernels take bf16 on CUDA, got {qkv.dtype}")
    if thd != 3 * heads * HEAD_DIM:
        raise ValueError(f"fused-qkv kernels need head dim {HEAD_DIM}: "
                         f"width {thd} with {heads} heads")
    if s > FUSED_QKV_MAX_SEQ:
        raise ValueError(
            f"sequence {s} > {FUSED_QKV_MAX_SEQ}: one head's K/V no longer fit "
            "in shared memory; long sequences need the blocked packed flash "
            "kernel (K3, _packed_fwd_kernel), not ported yet")
    for t in (qkv,) + others:
        if not t.is_contiguous() or t.device != qkv.device:
            raise ValueError("fused-qkv kernels take contiguous tensors on "
                             "one device")


def fused_qkv_fwd(qkv, heads: int, scale: float, with_lse: bool = False):
    """K1: qkv [B, S, 3*H*D] -> (out [B, S, H*D], lse2 [B, H, S] or None).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if qkv.device.type == "cpu":
        out, lse = qkv_attention_reference(qkv, heads, scale)
        return out, (lse if with_lse else None)
    _check_cuda(qkv, heads)
    b, s, thd = qkv.shape
    out = torch.empty((b, s, thd // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    lib = _build.load("fused_qkv_fwd")
    err = lib.unite_fused_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
        b, s, heads, scale * INV_LN2,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "fused_qkv_fwd")
    fused_qkv_fwd.launches += 1
    return out, lse


fused_qkv_fwd.launches = 0


def fused_qkv_bwd(qkv, out, lse, do, heads: int, scale: float):
    """K2: dqkv [B, S, 3*H*D] from qkv, the forward's out and lse2, and the
    cotangent do. CPU tensors take the plain version (which recomputes the
    softmax as the TPU kernel does and needs no out/lse)."""
    if qkv.device.type == "cpu":
        return qkv_attention_reference_bwd(qkv, do, heads, scale)
    _check_cuda(qkv, heads, out, lse, do)
    b, s, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device)
    lib = _build.load("fused_qkv_bwd")
    err = lib.unite_fused_qkv_bwd(
        qkv.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), b, s, heads, scale * INV_LN2,
        scale, torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "fused_qkv_bwd")
    fused_qkv_bwd.launches += 1
    return dqkv


fused_qkv_bwd.launches = 0


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale):
        train = ctx.needs_input_grad[0]
        out, lse = fused_qkv_fwd(qkv, heads, scale, with_lse=train)
        if train:
            ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        dqkv = fused_qkv_bwd(qkv, out, lse, do.contiguous(), ctx.heads,
                             ctx.scale)
        return dqkv, None, None


def fused_qkv_attention(qkv, heads: int, scale: float):
    """qkv [B, S, 3*H*D] (natural Linear layout) -> [B, S, H*D]."""
    return _FusedQKVAttention.apply(qkv, heads, scale)
