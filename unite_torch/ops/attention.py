"""Multi-head attention: plain PyTorch references and the packed-qkv kernels.

Counterpart of unite_tpu/ops/attention.py. The models run attention only
through ``fused_qkv_attention``: it consumes the qkv projection's natural
[B, S, 3*H*D] layout and returns [B, S, H*D], with the head split and merge
done inside the kernels. The route follows ``_fused_qkv_fwd`` in the JAX
package: S <= 512 (``FUSED_QKV_FWD_MAX_SEQ``) takes the fused-qkv kernels,
csrc/fused_qkv_fwd.cu (K1) and csrc/fused_qkv_bwd.cu (K2); longer sequences
take the packed flash kernels, csrc/packed_flash_fwd.cu (K3) and the dQ and
dK/dV kernels of csrc/packed_flash_bwd.cu (K4). Beside each kernel is its
plain version, with the TPU kernel's math and rounding points; a wrapper
uses it only for a tensor on the CPU. A CUDA tensor launches the kernel or
raises.

All kernels fold the softmax scale into a base-2 exponent,
exp(s*scale - m*scale) == exp2((s - m)*c) with c = scale*log2(e), and the
saved row statistic is the base-2 log-sum-exp of the scaled scores,
lse2 = m*c + log2(l), [B, H, S] fp32 (the TPU kernels broadcast it to
[B, H, S, 8]).
"""

from __future__ import annotations

import math

import torch

from unite_torch.ops import _build

INV_LN2 = 1.4426950408889634  # log2(e)
HEAD_DIM = 64
# The route: K1/K2 up to this length, K3/K4 beyond (unite_tpu's
# FUSED_QKV_FWD_MAX_SEQ).
FUSED_QKV_FWD_MAX_SEQ = 512
# K1/K2 hold one head's whole K and V (forward, dq) or Q and dO (dkv) in
# shared memory: 2*S*72*2 bytes, plus 8*S for the row statistics, under
# 227 KB. The route never sends them more than 512; this is their guard.
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


def _heads_of(x, heads):
    """[B, S, H*D] -> fp32 [B, H, S, D]."""
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2).float()


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
    g = _heads_of(do, heads)
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


def _check_cuda(qkv, heads, **aux):
    """What every kernel needs: bf16 qkv of head dim 64, and each auxiliary
    tensor (out, do, lse, delta, dqkv) of its shape and type, contiguous,
    on qkv's device."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"attention kernels take bf16 on CUDA, got {qkv.dtype}")
    b, s, thd = qkv.shape
    if thd != 3 * heads * HEAD_DIM:
        raise ValueError(f"attention kernels need head dim {HEAD_DIM}: "
                         f"width {thd} with {heads} heads")
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


def _check_resident(qkv):
    s = qkv.shape[1]
    if s > FUSED_QKV_MAX_SEQ:
        raise ValueError(
            f"sequence {s} > {FUSED_QKV_MAX_SEQ}: one head's K/V no longer fit "
            "in shared memory for K1/K2; sequences longer than "
            f"{FUSED_QKV_FWD_MAX_SEQ} take the packed flash kernels K3/K4 "
            "(fused_qkv_attention routes them there)")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
    _check_cuda(qkv, heads)
    _check_resident(qkv)
    out, lse = _fwd_outputs(qkv, heads, with_lse)
    lib = _build.load("fused_qkv_fwd")
    err = lib.unite_fused_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
        qkv.shape[0], qkv.shape[1], heads, scale * INV_LN2, _stream(qkv))
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
    _check_cuda(qkv, heads, out=out, lse=lse, do=do)
    _check_resident(qkv)
    b, s, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device)
    lib = _build.load("fused_qkv_bwd")
    err = lib.unite_fused_qkv_bwd(
        qkv.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), b, s, heads, scale * INV_LN2,
        scale, _stream(qkv))
    _build.check(err, "fused_qkv_bwd")
    fused_qkv_bwd.launches += 1
    return dqkv


fused_qkv_bwd.launches = 0


def packed_flash_reference(qkv, heads: int, scale: float):
    """Plain K3 (attention.py:913-934): the same function as plain K1. The
    TPU kernel blocks the queries but keeps every key in view, so the row
    max is the exact global one and p = exp2((s - m)*c) is rounded against
    it. Returns (out [B, S, H*D], lse2 [B, H, S] fp32)."""
    return qkv_attention_reference(qkv, heads, scale)


def _packed_dq_reference(qkv, out, lse, do, heads: int, scale: float):
    """Plain K4a (``_packed_dq_kernel``, :983-1011, delta as
    ``_packed_flash_bwd`` :1062-1063): delta = rowsum(do*o) in fp32, p
    from the lse in fp32, ds = p*(dp - delta)*scale rounded, dq = ds.k.
    Returns (dq [B, S, H*D], delta [B, H, S] fp32)."""
    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    g, o = _heads_of(do, heads), _heads_of(out, heads)
    delta = (g * o).sum(-1, keepdim=True)
    p = torch.exp2((q @ k.transpose(-1, -2)) * (scale * INV_LN2)
                   - lse[..., None])
    dp = g @ v.transpose(-1, -2)
    ds = (p * (dp - delta) * scale).to(qkv.dtype).float()
    return _merge_heads((ds @ k).to(qkv.dtype)), delta.squeeze(-1)


def _packed_dkv_reference(qkv, lse, delta, do, heads: int, scale: float):
    """Plain K4b (``_packed_dkv_kernel``, :1014-1047): p^T from the lse
    rounded to the working type, dv = p^T.do, ds^T = p^T*(dp^T -
    delta)*scale rounded, dk = ds^T.q. Returns (dk, dv), each
    [B, S, H*D]."""
    dt = qkv.dtype
    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    g = _heads_of(do, heads)
    pt = torch.exp2((k @ q.transpose(-1, -2)) * (scale * INV_LN2)
                    - lse[:, :, None, :]).to(dt).float()
    dv = pt @ g
    dpt = v @ g.transpose(-1, -2)
    dst = (pt * (dpt - delta[:, :, None, :]) * scale).to(dt).float()
    return _merge_heads((dst @ q).to(dt)), _merge_heads(dv.to(dt))


def packed_flash_reference_bwd(qkv, out, lse, do, heads: int, scale: float):
    """Plain K4: dqkv [B, S, 3*H*D] from qkv, K3's out and lse2 and the
    cotangent do. The dQ side keeps p in fp32 and the dK/dV side rounds
    p^T, as the two TPU kernels do (:1004 against :1035)."""
    dq, delta = _packed_dq_reference(qkv, out, lse, do, heads, scale)
    dk, dv = _packed_dkv_reference(qkv, lse, delta, do, heads, scale)
    return torch.cat([dq, dk, dv], dim=-1)


def packed_flash_fwd(qkv, heads: int, scale: float, with_lse: bool = False):
    """K3: qkv [B, S, 3*H*D] -> (out [B, S, H*D], lse2 [B, H, S] or None),
    any S. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if qkv.device.type == "cpu":
        out, lse = packed_flash_reference(qkv, heads, scale)
        return out, (lse if with_lse else None)
    _check_cuda(qkv, heads)
    out, lse = _fwd_outputs(qkv, heads, with_lse)
    lib = _build.load("packed_flash_fwd")
    err = lib.unite_packed_flash_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
        qkv.shape[0], qkv.shape[1], heads, scale * INV_LN2, _stream(qkv))
    _build.check(err, "packed_flash_fwd")
    packed_flash_fwd.launches += 1
    return out, lse


packed_flash_fwd.launches = 0


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
    _check_cuda(qkv, heads, out=out, lse=lse, do=do, dqkv=dqkv, delta=delta)
    lib = _build.load("packed_flash_bwd")
    err = lib.unite_packed_flash_dq(
        qkv.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), qkv.shape[0], qkv.shape[1],
        heads, scale * INV_LN2, scale, _stream(qkv))
    _build.check(err, "packed_flash_dq")
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
    _check_cuda(qkv, heads, lse=lse, delta=delta, do=do, dqkv=dqkv)
    lib = _build.load("packed_flash_bwd")
    err = lib.unite_packed_flash_dkv(
        qkv.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), qkv.shape[0], qkv.shape[1], heads,
        scale * INV_LN2, scale, _stream(qkv))
    _build.check(err, "packed_flash_dkv")
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


def uses_packed_route(seq: int) -> bool:
    """True where fused_qkv_attention takes K3/K4 rather than K1/K2."""
    return seq > FUSED_QKV_FWD_MAX_SEQ


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale):
        train = ctx.needs_input_grad[0]
        ctx.packed = uses_packed_route(qkv.shape[1])
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
    K1/K2 up to 512 tokens and K3/K4 beyond."""
    return _FusedQKVAttention.apply(qkv, heads, scale)
