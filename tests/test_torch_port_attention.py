"""unite_torch fused-qkv attention against the Pallas kernels in interpret mode.

The JAX side runs ``unite_tpu.ops.attention.fused_qkv_attention`` with
``_INTERPRET`` and ``_on_tpu`` patched, so its forward goes through
``_fused_qkv_kernel`` (K1) and its VJP through ``_fused_qkv_bwd_kernel``
(K2), emulated on the CPU. The port's CPU path is the kernels' plain
versions. Width 128 = 2 heads of 64 keeps the Pallas 128-lane rule.
The kernels themselves are held against these plain versions on the card
by tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA

HEADS, SCALE = 2, 64 ** -0.5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(A, "_on_tpu", lambda: True)


def _qkv(b, s, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 3 * HEADS * 64)).astype(dtype)


def _jax_dtype(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _to_np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-5, atol=1e-6)),
                                       ("bfloat16", dict(rtol=0, atol=2e-2))])
@pytest.mark.parametrize("s", [37, 197, 320])
def test_forward_matches_pallas_k1(interpret, s, dtype, tol):
    x = _qkv(2, s, seed=s)
    jx = jnp.asarray(x).astype(_jax_dtype(dtype))
    ref = _to_np(A.fused_qkv_attention(jx, HEADS, SCALE))
    tx = torch.from_numpy(_to_np(jx)).to(_torch_dtype(dtype))
    out = TA.fused_qkv_attention(tx, HEADS, SCALE)
    assert out.dtype == tx.dtype and out.shape == (2, s, HEADS * 64)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-5, atol=1e-5)),
                                       ("bfloat16", dict(rtol=0, atol=2e-2))])
@pytest.mark.parametrize("s", [37, 197, 320])
def test_backward_matches_pallas_k2(interpret, s, dtype, tol):
    x = _qkv(2, s, seed=100 + s)
    g = np.random.default_rng(s).standard_normal(
        (2, s, HEADS * 64)).astype(np.float32)
    jdt = _jax_dtype(dtype)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    _, vjp = jax.vjp(lambda t: A.fused_qkv_attention(t, HEADS, SCALE), jx)
    ref = _to_np(vjp(jg)[0])
    tdt = _torch_dtype(dtype)
    tx = torch.from_numpy(_to_np(jx)).to(tdt).requires_grad_(True)
    TA.fused_qkv_attention(tx, HEADS, SCALE).backward(
        torch.from_numpy(_to_np(jg)).to(tdt))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(tx.grad.float().numpy() / scale, ref / scale,
                               **tol)


def test_plain_versions_match_attention_reference():
    # fp32: the kernel's rounding points are no-ops, so the plain versions
    # are plain attention and its gradient up to fp32 summation order
    x = torch.from_numpy(_qkv(2, 50, seed=7))
    out, lse = TA.qkv_attention_reference(x, HEADS, SCALE)
    q, k, v = TA._split_heads(x, HEADS)
    ref = TA._merge_heads(TA.attention_reference(q, k, v, scale=SCALE))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    s = (q @ k.transpose(-1, -2)) * SCALE
    torch.testing.assert_close(lse, torch.logsumexp(s, -1) * TA.INV_LN2,
                               rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(_qkv(2, 50, seed=8)[..., :HEADS * 64].copy())
    xg = x.clone().requires_grad_(True)
    qg, kg, vg = TA._split_heads(xg, HEADS)
    TA._merge_heads(TA.attention_reference(qg, kg, vg, scale=SCALE)
                    ).backward(g)
    torch.testing.assert_close(
        TA.qkv_attention_reference_bwd(x, g, HEADS, SCALE), xg.grad,
        rtol=1e-5, atol=1e-5)


def test_cpu_path_launches_no_kernel():
    before = (TA.fused_qkv_fwd.launches, TA.fused_qkv_bwd.launches)
    x = torch.from_numpy(_qkv(1, 20, seed=3)).requires_grad_(True)
    TA.fused_qkv_attention(x, HEADS, SCALE).sum().backward()
    assert (TA.fused_qkv_fwd.launches, TA.fused_qkv_bwd.launches) == before
    assert before == (0, 0)


def test_cpu_fwd_returns_lse_only_on_request():
    x = torch.from_numpy(_qkv(1, 20, seed=4))
    assert TA.fused_qkv_fwd(x, HEADS, SCALE)[1] is None
    assert TA.fused_qkv_fwd(x, HEADS, SCALE, with_lse=True)[1].shape == (1, 2, 20)
