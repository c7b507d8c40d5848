"""The fp32 attention kernels' plain version against unite_tpu, on the CPU.

At fp32 the card's attention routes K1-K6 all launch the SIMT kernels of
unite_torch/csrc/attn_fp32.cu, whose plain version is
``attention_fp32_reference`` and its backward (the exact row max, p kept in
fp32). On the TPU an fp32 model runs the Pallas kernels themselves in fp32
(they cast only to their inputs' dtype), so here that plain version, on
inputs made by numpy from a seed, is held against each of them run by JAX
at fp32 in interpret mode (``_INTERPRET`` and ``_on_tpu`` patched, as
tests/test_torch_port_flash.py runs them):

* K1 ``_fused_qkv_fwd`` and K2 ``_fused_qkv_bwd`` (packed qkv; K2 up to
  its training cap of 384 keys), K3 ``_packed_flash_fwd`` and K4
  ``_packed_flash_bwd`` (packed qkv, a divisor query block: 600, 1568),
  K5 ``_grouped_attention`` (up to 512 keys) and K6 ``_flash_fwd`` and the
  VJP of ``_flash_attention`` (513 and 1569 keys, no divisor block);
* at head dims 64 and 80 (the packed routes at 2 heads of 64 or 8 of 80,
  JAX's lane blocks being 128 wide), at lengths on both sides of each route
  boundary, rtol = atol = 1e-5 on values scaled by max(1, max |ref|)
  (summation order; at fp32 the TPU kernels' casts are identities);
* against each route's own plain version at fp32, and the wrappers'
  dispatch: a CUDA (here: meta) fp32 tensor reaches the fp32 entries on
  every route with the strides of its views, a bf16 one the ``wgmma``
  entries, an fp16 one raises ``TypeError``, and a view whose rows are
  not 16-byte aligned (the kernels' 16-byte copies and loads) raises
  ``ValueError`` before any launch;
* the source itself: fp32 FMAs only, no tensor-core product, no TF32
  rounding and no library call in csrc/attn_fp32.cu.

The CUDA kernels are held against the plain version on the card by
chip_smoke.py (``check_fp32_kernels``) and tests/test_torch_port_cuda.py
(``-k fp32``).
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA
from unite_torch.ops import _build

TOL = dict(rtol=1e-5, atol=1e-5)
PACKED_HEADS = {64: 2, 80: 8}  # JAX's packed kernels block 128 lanes
VIEW_HEADS = 2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(A, "_on_tpu", lambda: True)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(_np(x)))


def _close(got, ref, what=""):
    ref = _np(ref) if not isinstance(ref, np.ndarray) else ref
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, err_msg=what, **TOL)


def _plain(q, k, v, do, scale):
    """The plain fp32 version's forward and backward on [B, H, S, D]."""
    o, lse = TA.attention_fp32_reference(q, k, v, scale)
    return (o, lse) + TA.attention_fp32_reference_bwd(q, k, v, o, lse, do,
                                                      scale)


def _packed_plain(x, g, heads, scale):
    """The plain fp32 version on packed qkv [B, S, 3*H*D]: (out [B, S, H*D],
    lse2, dqkv)."""
    o, lse, dq, dk, dv = _plain(*TA._split_heads(x, heads),
                                TA._heads_of(g, heads), scale)
    return (TA._merge_heads(o), lse,
            torch.cat([TA._merge_heads(t) for t in (dq, dk, dv)], dim=-1))


# ----------------------------------------------- against the JAX kernels


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", [41, 197, 384, 392])
def test_plain_fp32_matches_k1_k2(interpret, s, d):
    heads, scale = PACKED_HEADS[d], d ** -0.5
    jx = jnp.asarray(_rand((2, s, 3 * heads * d), s + d))
    jg = jnp.asarray(_rand((2, s, heads * d), 100 + s + d))
    out, res = A._fused_qkv_fwd(jx, heads, scale)
    assert res[2] is None  # K1 ran, not the packed flash route
    o, _, dqkv = _packed_plain(_t(jx), _t(jg), heads, scale)
    _close(o, out, "K1 out")
    if s <= A.FUSED_QKV_MAX_SEQ:  # K2's training cap
        _close(dqkv, A._fused_qkv_bwd(heads, scale, res, jg)[0], "K2 dqkv")


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", [600, 1568])
def test_plain_fp32_matches_k3_k4(interpret, s, d):
    heads, scale = PACKED_HEADS[d], d ** -0.5
    assert TA.use_fused_qkv(s, False, heads * d) and TA.packed_flash_ok(s)
    jx = jnp.asarray(_rand((1, s, 3 * heads * d), s + d))
    jg = jnp.asarray(_rand((1, s, heads * d), 200 + s + d))
    out, lse = A._packed_flash_fwd(jx, heads, scale)
    o, tlse, dqkv = _packed_plain(_t(jx), _t(jg), heads, scale)
    _close(o, out, "K3 out")
    _close(tlse, _np(lse)[..., 0], "K3 lse2")
    _close(dqkv, A._packed_flash_bwd(jx, out, lse, jg, heads, scale),
           "K4 dqkv")


def _views(s, d, seed):
    q, k, v, g = (jnp.asarray(_rand((1, VIEW_HEADS, s, d), seed + i))
                  for i in range(4))
    return q, k, v, g


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", [1, 41, 197, 384, 392, 512])
def test_plain_fp32_matches_k5(interpret, s, d):
    scale = d ** -0.5
    q, k, v, g = _views(s, d, 300 + s + d)
    out, vjp = jax.vjp(lambda *a: A._grouped_attention(*a, scale), q, k, v)
    o, _, *grads = _plain(*(_t(x) for x in (q, k, v, g)), scale)
    _close(o, out, "K5 out")
    for name, a, ref in zip("qkv", grads, vjp(g)):
        _close(a, ref, f"K5 d{name}")


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", [513, 1569])
def test_plain_fp32_matches_k6(interpret, s, d):
    scale = d ** -0.5
    q, k, v, g = _views(s, d, 400 + s + d)
    _, lse, _ = A._flash_fwd(q, k, v, scale, A.DEFAULT_BLOCK_Q)
    out, vjp = jax.vjp(lambda *a: A._flash_attention(*a, scale, 128, 128),
                       q, k, v)
    o, tlse, *grads = _plain(*(_t(x) for x in (q, k, v, g)), scale)
    _close(o, out, "K6 out")
    # the TPU pads the queries and broadcasts lse over 8 lanes
    _close(tlse, _np(lse)[:VIEW_HEADS, :s, 0][None], "K6 lse2")
    for name, a, ref in zip("qkv", grads, vjp(g)):
        _close(a, ref, f"K6 d{name}")


# ------------------------------------- against the routes' plain versions


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", [1, 64, 197, 392, 600, 1569])
def test_plain_fp32_equals_each_routes_plain_version(s, d):
    scale = d ** -0.5
    q, k, v, g = (torch.from_numpy(_rand((2, 3, s, d), 500 + s + d + i))
                  for i in range(4))
    o, lse, *grads = _plain(q, k, v, g, scale)
    # K6 (and K1/K3, its arithmetic on the packed layout)
    fo, flse = TA.flash_reference(q, k, v, scale=scale)
    _close(fo, o.numpy(), "K6 o")
    _close(flse, lse.numpy(), "K6 lse2")
    for name, a, ref in zip("qkv", TA.flash_reference_bwd(
            q, k, v, o, lse, g, scale=scale), grads):
        _close(a, ref.numpy(), f"K6 d{name}")
    # K5: its statistics are (m, l); lse2 = m*c + log2(l)
    go, m, l = TA.grouped_reference(q, k, v, scale=scale)
    _close(go, o.numpy(), "K5 o")
    _close(m * (scale * TA.INV_LN2) + torch.log2(l), lse.numpy(), "K5 lse2")
    for name, a, ref in zip("qkv", TA.grouped_reference_bwd(
            q, k, v, g, scale=scale), grads):
        _close(a, ref.numpy(), f"K5 d{name}")
    # K1/K2 and K3/K4 on the packed layout of the same heads
    x = torch.cat([TA._merge_heads(t) for t in (q, k, v)], dim=-1)
    gm = TA._merge_heads(g)
    po, plse, pdqkv = _packed_plain(x, gm, 3, scale)
    _close(TA.qkv_attention_reference(x, 3, scale)[0], po.numpy(), "K1 out")
    _close(TA.qkv_attention_reference_bwd(x, gm, 3, scale), pdqkv.numpy(),
           "K2 dqkv")
    ko, klse = TA.packed_flash_reference(x, 3, scale)
    _close(ko, po.numpy(), "K3 out")
    _close(TA.packed_flash_reference_bwd(x, ko, klse, gm, 3, scale),
           pdqkv.numpy(), "K4 dqkv")


def test_fp32_wrappers_take_the_plain_version_on_the_cpu():
    s, d, scale = 97, 80, 80 ** -0.5
    q, k, v, g = (torch.from_numpy(_rand((1, 2, s, d), 600 + i))
                  for i in range(4))
    o, lse, *grads = _plain(q, k, v, g, scale)
    got, got_lse = TA.fp32_attn_fwd(q, k, v, scale, with_lse=True)
    assert torch.equal(got, o) and torch.equal(got_lse, lse)
    assert TA.fp32_attn_fwd(q, k, v, scale)[1] is None
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((1, 2, s))
    TA.fp32_attn_dq(q, k, v, o, g, lse, dq, delta, scale)
    TA.fp32_attn_dkv(q, k, v, g, lse, delta, dk, dv, scale)
    for a, ref in zip((dq, dk, dv), grads):
        assert torch.equal(a, ref)
    assert torch.allclose(delta, (g * o).sum(-1))
    with pytest.raises(TypeError):
        TA.attention_fp32_reference(q.bfloat16(), k, v, scale)
    with pytest.raises(TypeError):
        TA.fp32_attn_fwd(q.half(), k.half(), v.half(), scale)


# ------------------------------------------------------------ dispatch

ENTRIES = ("unite_short_qkv_fwd", "unite_short_qkv_bwd", "unite_flash_fwd",
           "unite_flash_dq", "unite_flash_dkv", "unite_short_grouped_fwd",
           "unite_short_grouped_dq", "unite_short_grouped_dkv",
           "unite_fp32_attn_fwd", "unite_fp32_attn_dq", "unite_fp32_attn_dkv")
ROUTE_COUNTERS = ("fused_qkv_fwd", "fused_qkv_bwd", "packed_flash_fwd",
                  "packed_flash_dq", "packed_flash_dkv", "flash_fwd",
                  "flash_dq", "flash_dkv", "grouped_fwd", "grouped_dq",
                  "grouped_dkv")
FP32_COUNTERS = ("fp32_attn_fwd", "fp32_attn_dq", "fp32_attn_dkv")


@pytest.fixture
def entry(monkeypatch):
    """Record the calls that reach the kernels' C entries, with every
    wrapper's counters started afresh (and restored afterwards)."""
    calls = []

    def load(name):
        return SimpleNamespace(**{
            e: (lambda *a, e=e: calls.append((name, e, a)) or 0)
            for e in ENTRIES})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(TA, "_stream", lambda t: 7)
    for name in ROUTE_COUNTERS + FP32_COUNTERS:
        monkeypatch.setattr(getattr(TA, name), "launches", 0)
    for name in FP32_COUNTERS:
        monkeypatch.setattr(getattr(TA, name), "by_route", type(
            TA.fp32_attn_fwd.by_route)())
    for name in ("fused_qkv_fwd", "packed_flash_fwd"):
        monkeypatch.setattr(getattr(TA, name), "by_shape", type(
            TA.fused_qkv_fwd.by_shape)())
    return calls


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checks_take_fp32_and_bf16_and_refuse_fp16(dtype):
    qkv = _meta(2, 197, 3 * 128, dtype=dtype)
    assert TA._check_cuda(qkv, 2) == 64
    q = _meta(2, 3, 197, 80, dtype=dtype)
    ptrs, strides = TA._view_args(q, q, q)
    assert list(strides) == list(q.stride()[:3]) * 3 and len(ptrs) == 3
    with pytest.raises(TypeError):
        TA._check_cuda(qkv.half(), 2)
    with pytest.raises(TypeError):
        TA._view_args(q.half(), q.half())
    with pytest.raises(TypeError):  # one dtype for all views
        TA._view_args(q, q.half())


# (S, the route's kernel ids at fp32 by entry, its bf16 C entries)
ROUTES = [
    (197, {"fwd": "K1", "dq": "K2", "dkv": "K2"},
     ("unite_short_qkv_fwd", "unite_short_qkv_bwd")),
    (392, {"fwd": "K5", "dq": "K5", "dkv": "K5"},
     ("unite_short_grouped_fwd", "unite_short_grouped_dq",
      "unite_short_grouped_dkv")),
    (1568, {"fwd": "K3", "dq": "K4", "dkv": "K4"},
     ("unite_flash_fwd", "unite_flash_dq", "unite_flash_dkv")),
    (1569, {"fwd": "K6", "dq": "K6", "dkv": "K6"},
     ("unite_flash_fwd", "unite_flash_dq", "unite_flash_dkv")),
]


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s,fp32_routes,bf16_entries", ROUTES)
def test_every_route_launches_the_fp32_entries_at_fp32(entry, s, fp32_routes,
                                                       bf16_entries, d):
    heads = 128 // 64 if d == 64 else 8
    width = heads * d
    for dtype in (torch.float32, torch.bfloat16):
        entry.clear()
        qkv = _meta(2, s, 3 * width, dtype=dtype).requires_grad_()
        out = TA.self_attention(qkv, heads, d ** -0.5, dim=width)
        assert out.shape == (2, s, width) and out.dtype == dtype
        out.sum().backward()
        assert qkv.grad.shape == qkv.shape
        names = [e for _, e, _ in entry]
        if dtype == torch.bfloat16:
            assert tuple(names) == bf16_entries
            continue
        assert names == ["unite_fp32_attn_fwd", "unite_fp32_attn_dq",
                         "unite_fp32_attn_dkv"]
        assert {lib for lib, _, _ in entry} == {"attn_fp32"}
        fwd, dq, dkv = (a for _, _, a in entry)
        # the views' strides: packed lanes of qkv on the packed routes,
        # strided views of qkv on K5/K6 (the same numbers), B and H last
        wide = (s * 3 * width, d, 3 * width)
        assert list(fwd[5])[:9] == list(wide * 3)
        assert fwd[6:10] == (2, s, heads, d) and fwd[4] is not None
        assert fwd[10] == pytest.approx(d ** -0.5 * TA.INV_LN2)
        assert dq[9:13] == dkv[9:13] == (2, s, heads, d)
        assert dq[13:] == dkv[13:] == (pytest.approx(d ** -0.5 * TA.INV_LN2),
                                       pytest.approx(d ** -0.5), 7)
        # dq's lse and delta are dkv's, and delta is written by dq
        assert dq[5] == fwd[4] == dkv[4] and dq[6] == dkv[5]
        for kind, key in (("fwd", "fwd"), ("dq", "dq"), ("dkv", "dkv")):
            counter = getattr(TA, f"fp32_attn_{kind}")
            assert counter.launches == 1
            assert dict(counter.by_route) == {fp32_routes[key]: 1}
        assert all(getattr(TA, n).launches == 0 for n in ROUTE_COUNTERS)
        for name in FP32_COUNTERS:
            getattr(TA, name).launches = 0
            getattr(TA, name).by_route.clear()


def test_fp32_views_take_any_length_and_fp16_raises(entry):
    # no shared-memory guard at fp32: K1 and K5 past their bf16 caps
    x = _meta(1, 900, 3 * 128)
    TA.fused_qkv_fwd(x, 2, 0.125)
    q = _meta(1, 2, 4608, 64)
    TA.grouped_fwd(q, q, q, 0.125)
    assert [e for _, e, _ in entry] == ["unite_fp32_attn_fwd"] * 2
    assert dict(TA.fp32_attn_fwd.by_route) == {"K1": 1, "K5": 1}
    h = _meta(1, 2, 64, 64, dtype=torch.float16)
    for f in (TA.flash_fwd, TA.grouped_fwd):
        with pytest.raises(TypeError):
            f(h, h, h, 0.125)
    with pytest.raises(TypeError):
        TA.fused_qkv_attention(x.half(), 2, 0.125)
    with pytest.raises(ValueError):  # head dims stay 64 and 80
        TA.fp32_attn_fwd(*(_meta(1, 2, 64, 96),) * 3, 0.125)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_fp32_entries_refuse_misaligned_views(entry, kind):
    # the kernels read and write rows by 16-byte copies and loads: every
    # route's views pass (16-byte aligned pointers, strides a multiple of 8
    # floats), a pointer or a row stride off that raises before any launch
    b, h, s, d = 2, 3, 100, 80
    stat = _meta(b, h, s)

    def call(x):
        if kind == "fwd":
            TA.fp32_attn_fwd(x, x, x, 0.125, with_lse=True)
        elif kind == "dq":
            TA.fp32_attn_dq(x, x, x, x, x, stat, x, stat, 0.125)
        else:
            TA.fp32_attn_dkv(x, x, x, x, stat, stat, x, x, 0.125)

    qkv = _meta(b, s, 3 * h * d)
    for x in (_meta(b, h, s, d), TA._split_heads(qkv, h)[1]):
        call(x)
    assert [e for _, e, _ in entry] == [f"unite_fp32_attn_{kind}"] * 2
    for _, _, args in entry:
        assert all(a % 16 == 0 for a in args[:4])
    shifted = _meta(1 + b * h * s * d)[1:].view(b, h, s, d)  # 4 bytes in
    wide = _meta(b, h, s, d + 1)[..., :d]  # rows of 81 floats
    for x in (shifted, wide):
        with pytest.raises(ValueError):
            call(x)
    assert len(entry) == 2


def _code(path):
    """A CUDA source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_fp32_source_is_fp32_fmas_only():
    # the fp32 kernels compute the CPU's function: every product an fp32
    # FMA on the SMs' cores, no tensor-core instruction, no TF32 rounding of
    # an operand, no library kernel, no header that brings either in
    code = _code(_build.CSRC / "attn_fp32.cu")
    assert "fmaf(" in code and "cp.async" in code
    for word in ("mma", "tf32", "cvt.rna", "cublas", "cudnn", "cutlass",
                 "__half", "bfloat16"):
        assert word not in code.lower(), word
    assert re.findall(r'#include\s*[<"]([^>"]+)', code) == [
        "cuda_runtime.h", "math.h"]
