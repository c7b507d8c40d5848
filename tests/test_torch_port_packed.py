"""unite_torch packed flash attention (K3/K4) against the Pallas kernels in
interpret mode.

The JAX side runs ``_packed_flash_fwd`` (``_packed_fwd_kernel``, K3) and
``_packed_flash_bwd`` (``_packed_dq_kernel`` and ``_packed_dkv_kernel``,
K4) with ``_INTERPRET`` and ``_on_tpu`` patched, emulated on the CPU; with
those patches ``fused_qkv_attention`` at S = 784 takes the same packed
route. The port's CPU path is the kernels' plain versions. Width 128 = 2
heads of 64 keeps the Pallas 128-lane rule. The CUDA kernels are held
against these plain versions on the card by tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA

HEADS, SCALE = 2, 64 ** -0.5
DTYPES = [("float32", dict(rtol=1e-5, atol=1e-5)),
          ("bfloat16", dict(rtol=0, atol=2e-2))]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(A, "_on_tpu", lambda: True)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jdt(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _tdt(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _torch(x, dtype):
    return torch.from_numpy(_np(x)).to(_tdt(dtype))


def _scaled(a, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    return a / scale, ref / scale


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", [256, 784])
def test_plain_k3_matches_pallas(interpret, s, dtype, tol):
    jx = jnp.asarray(_rand((2, s, 3 * HEADS * 64), s)).astype(_jdt(dtype))
    out, lse = A._packed_flash_fwd(jx, HEADS, SCALE)
    tout, tlse = TA.packed_flash_fwd(_torch(jx, dtype), HEADS, SCALE,
                                     with_lse=True)
    assert tout.shape == (2, s, HEADS * 64) and tlse.shape == (2, HEADS, s)
    np.testing.assert_allclose(tout.float().numpy(), _np(out), **tol)
    # the TPU broadcasts lse over 8 sublanes; the port keeps [B, H, S]
    np.testing.assert_allclose(tlse.numpy(), _np(lse[..., 0]),
                               rtol=1e-5, atol=1e-5 if dtype == "float32"
                               else 1e-3)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", [256, 784])
def test_plain_k4_matches_pallas(interpret, s, dtype, tol):
    jdt = _jdt(dtype)
    jx = jnp.asarray(_rand((2, s, 3 * HEADS * 64), 10 + s)).astype(jdt)
    jg = jnp.asarray(_rand((2, s, HEADS * 64), 20 + s)).astype(jdt)
    out, lse = A._packed_flash_fwd(jx, HEADS, SCALE)
    ref = _np(A._packed_flash_bwd(jx, out, lse, jg, HEADS, SCALE))
    # the same out and lse on both sides
    got = TA.packed_flash_bwd(_torch(jx, dtype), _torch(out, dtype),
                              torch.from_numpy(_np(lse[..., 0])),
                              _torch(jg, dtype), HEADS, SCALE)
    assert got.dtype == _tdt(dtype) and got.shape == jx.shape
    np.testing.assert_allclose(*_scaled(got.float().numpy(), ref), **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_attention_route_matches_jax_at_784(interpret, dtype, tol):
    # hd = 128 and S > 512: both packages take the packed route
    jdt = _jdt(dtype)
    jx = jnp.asarray(_rand((2, 784, 3 * HEADS * 64), 5)).astype(jdt)
    jg = jnp.asarray(_rand((2, 784, HEADS * 64), 6)).astype(jdt)
    out, vjp = jax.vjp(lambda t: A.fused_qkv_attention(t, HEADS, SCALE), jx)
    ref_dx = _np(vjp(jg)[0])
    tx = _torch(jx, dtype).requires_grad_(True)
    tout = TA.fused_qkv_attention(tx, HEADS, SCALE)
    np.testing.assert_allclose(tout.detach().float().numpy(), _np(out), **tol)
    tout.backward(_torch(jg, dtype))
    np.testing.assert_allclose(*_scaled(tx.grad.float().numpy(), ref_dx),
                               **tol)


def test_plain_k4_is_the_gradient_in_fp32():
    # fp32: the rounding points are no-ops, so plain K4 is autograd's
    # gradient of plain attention up to summation order
    x = torch.from_numpy(_rand((2, 70, 3 * HEADS * 64), 1))
    g = torch.from_numpy(_rand((2, 70, HEADS * 64), 2))
    out, lse = TA.packed_flash_reference(x, HEADS, SCALE)
    xg = x.clone().requires_grad_(True)
    q, k, v = TA._split_heads(xg, HEADS)
    TA._merge_heads(TA.attention_reference(q, k, v, scale=SCALE)).backward(g)
    torch.testing.assert_close(
        TA.packed_flash_reference_bwd(x, out, lse, g, HEADS, SCALE), xg.grad,
        rtol=1e-5, atol=1e-5)


def test_route_switches_above_512_and_no_counter_moves(monkeypatch):
    # the models' training route: K1/K2 to 384, K5 at 385-512; above, K3/K4
    # where S has a divisor query block (520 = 5 * 104), K6 where it has
    # none (513)
    counters = (TA.fused_qkv_fwd, TA.fused_qkv_bwd, TA.packed_flash_fwd,
                TA.packed_flash_dq, TA.packed_flash_dkv, TA.flash_fwd,
                TA.flash_dq, TA.flash_dkv, TA.grouped_fwd, TA.grouped_dq,
                TA.grouped_dkv)
    before = [c.launches for c in counters]
    calls = []
    for name in ("fused_qkv_fwd", "fused_qkv_bwd", "packed_flash_fwd",
                 "packed_flash_bwd", "flash_fwd", "flash_bwd", "grouped_fwd",
                 "grouped_bwd"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    for s, route in ((384, ["fused_qkv_fwd", "fused_qkv_bwd"]),
                     (512, ["grouped_fwd", "grouped_bwd"]),
                     (520, ["packed_flash_fwd", "packed_flash_bwd"]),
                     (513, ["flash_fwd", "flash_bwd"])):
        calls.clear()
        x = torch.from_numpy(_rand((1, s, 3 * HEADS * 64), s)
                             ).requires_grad_(True)
        TA.self_attention(x, HEADS, SCALE).sum().backward()
        assert calls == route, s
    # forward-only, 512 tokens stay on K1
    calls.clear()
    TA.self_attention(torch.from_numpy(_rand((1, 512, 3 * HEADS * 64), 5)),
                      HEADS, SCALE, fwd_only=True)
    assert calls == ["fused_qkv_fwd"]
    assert [c.launches for c in counters] == before == [0] * 11
