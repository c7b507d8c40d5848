"""Head dim 80 in the [B, H, S, D] kernels K5 and K6, against unite_tpu on
the CPU.

``pretrain_videomae_huge_patch16_224`` has 16 heads of 80 lanes in its
encoder. Its training route sends 385-512 visible tokens (mask 0.75: 392;
mask 0.7: 472) to K5 and lengths above 512 with no divisor query block
(mask 0.6: 632) to K6, on strided [B, H, S, 80] views of qkv. Here, with
inputs made by numpy from a seed:

* plain K5 (``grouped_fwd`` / ``grouped_bwd`` on the CPU) at S = 7, 160,
  392 and 512 against ``_grouped_attention``, and plain K6 (``flash_fwd``,
  ``flash_reference_bwd``) at S = 577, 632 and 1569 against ``_flash_fwd``
  and the VJP of ``_flash_attention``, 2 and 8 heads, the Pallas kernels in
  interpret mode (``_INTERPRET`` and ``_on_tpu`` patched, as
  tests/test_kernel_interpret.py runs them). Tolerances are those of
  tests/test_torch_port_grouped.py and tests/test_torch_port_flash.py:
  fp32 rtol = atol = 1e-5, bf16 atol 2e-2 on values scaled by
  max(1, max |ref|);
* what the K5 and K6 wrappers hand the C entry points at D = 80 (view
  pointers, strides and the head dim), through a faked entry on meta
  tensors, which take the wrappers' CUDA path, and which cotangents
  ``_kernel_layout`` copies;
* K5's forward guard of 512 keys at D = 80;
* a ``PretrainVideoMAE`` 640 wide with 8 heads of 80 in both towers at 392
  and at 632 visible tokens against JAX through utils/flax_bridge.py in
  fp32: forward, loss and every gradient within 1e-5, the encoder's
  attention through K5's and K6's plain versions (the wrappers' calls
  recorded; the CPU counts no launch).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_port_cuda.py (``-k head_dim80``) and chip_smoke.py.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA
from unite_tpu.engines import pretrain_videomae as jeng
from unite_tpu.models import pretrain_videomae as jmae
from unite_tpu.ops import normalize as jnorm
from unite_torch.engines import pretrain_videomae as teng
from unite_torch.models import pretrain_videomae as tmae
from unite_torch.ops import _build
from unite_torch.ops.masking import TubeMaskingGenerator
from unite_torch.utils.flax_bridge import flax_to_state_dict

D = 80
SCALE = D ** -0.5
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


def _inputs(heads, s, seed, dtype):
    return [jnp.asarray(_rand((1, heads, s, D), seed + i)).astype(_jdt(dtype))
            for i in range(4)]


# ----------------------------------------------------------- K5 and K6


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("heads", [2, 8])
@pytest.mark.parametrize("s", [7, 160, 392, 512])
def test_plain_k5_matches_pallas_at_80(interpret, s, heads, dtype, tol):
    q, k, v, g = _inputs(heads, s, s + heads, dtype)
    out, vjp = jax.vjp(lambda *a: A._grouped_attention(*a, SCALE), q, k, v)
    refs = vjp(g)
    tq, tk, tv, tg = (_torch(x, dtype) for x in (q, k, v, g))
    got, (m, l) = TA.grouped_fwd(tq, tk, tv, SCALE, with_stats=True)
    assert got.shape == (1, heads, s, D) and got.dtype == _tdt(dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(out), **tol)
    for name, a, ref in zip("qkv", TA.grouped_bwd(tq, tk, tv, tg, m, l,
                                                  SCALE), refs):
        assert a.dtype == _tdt(dtype), name
        np.testing.assert_allclose(*_scaled(a.float().numpy(), _np(ref)),
                                   err_msg=f"d{name}", **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("heads", [2, 8])
@pytest.mark.parametrize("s", [577, 632, 1569])
def test_plain_k6_matches_pallas_at_80(interpret, s, heads, dtype, tol):
    q, k, v, g = _inputs(heads, s, 10 * s + heads, dtype)
    out, lse, _ = A._flash_fwd(q, k, v, SCALE, A.DEFAULT_BLOCK_Q)
    tq, tk, tv, tg = (_torch(x, dtype) for x in (q, k, v, g))
    tout, tlse = TA.flash_fwd(tq, tk, tv, SCALE, with_lse=True)
    assert tout.shape == (1, heads, s, D) and tlse.shape == (1, heads, s)
    # the TPU pads the queries to a multiple of 128 and broadcasts lse
    np.testing.assert_allclose(tout.float().numpy()[0],
                               _np(out)[:heads, :s], **tol)
    np.testing.assert_allclose(tlse.numpy()[0], _np(lse)[:heads, :s, 0],
                               rtol=1e-5, atol=1e-5 if dtype == "float32"
                               else 1e-3)
    _, vjp = jax.vjp(lambda *a: A._flash_attention(*a, SCALE, 128, 128),
                     q, k, v)
    refs = vjp(g)
    # the same o and lse on both sides
    got = TA.flash_reference_bwd(
        tq, tk, tv, _torch(_np(out)[None, :heads, :s], dtype),
        torch.from_numpy(_np(lse)[None, :heads, :s, 0]), tg, scale=SCALE)
    for name, a, ref in zip("qkv", got, refs):
        assert a.dtype == _tdt(dtype), name
        np.testing.assert_allclose(*_scaled(a.float().numpy(), _np(ref)),
                                   err_msg=f"d{name}", **tol)


def test_the_route_sends_the_huge_encoder_to_k5_and_k6():
    # 8 * (196 - int(r * 196)) visible tokens at tube-mask ratio r, 1280
    # wide: K1/K2 up to 384 in training, K5 to 512, K6 beyond where no
    # divisor query block exists, K3/K4 where one does
    visible = {r: 8 * (196 - int(r * 196)) for r in (0.9, 0.75, 0.7, 0.6,
                                                     0.5)}
    assert visible == {0.9: 160, 0.75: 392, 0.7: 472, 0.6: 632, 0.5: 784}
    assert TA.use_fused_qkv(160, False, 1280)
    for s in (392, 472):
        assert not TA.use_fused_qkv(s, False, 1280)
        assert s <= TA.GROUPED_MAX_SEQ <= TA.RESIDENT_MAX_SEQ[D]
        assert TA.use_fused_qkv(s, True, 1280)  # forward-only: K1
    assert not TA.packed_flash_ok(632) and not TA.use_fused_qkv(632, True,
                                                                1280)
    assert TA.packed_flash_ok(784) and TA.use_fused_qkv(784, False, 1280)


# ------------------------------------------------- what the entries get

ENTRIES = ("unite_flash_fwd", "unite_flash_dq", "unite_flash_dkv",
           "unite_short_grouped_fwd", "unite_short_grouped_dq",
           "unite_short_grouped_dkv")
COUNTERS = ("flash_fwd", "flash_dq", "flash_dkv", "grouped_fwd",
            "grouped_dq", "grouped_dkv")


@pytest.fixture
def entry(monkeypatch):
    """Record the calls that reach the kernels' C entries, with the
    wrappers' counters started afresh (and restored afterwards)."""
    calls = []

    def load(name):
        return SimpleNamespace(**{
            e: (lambda *a, e=e: calls.append((name, e, a)) or 0)
            for e in ENTRIES})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(TA, "_stream", lambda t: 7)
    for name in COUNTERS:
        monkeypatch.setattr(getattr(TA, name), "launches", 0)
    return calls


def _views(layout, b, s, h):
    """q, k, v and a cotangent do [B, H, S, 80] on the meta device, slices
    of one buffer (each with its own data pointer): views of a qkv
    projection and a cotangent laid out as the models lay it out, or
    contiguous tensors."""
    buf = torch.empty(1 << 30, dtype=torch.bfloat16, device="meta")
    n = b * s * h * D
    if layout == "views":
        q, k, v = TA._split_heads(buf[:3 * n].view(b, s, 3 * h * D), h)
        return q, k, v, TA._heads_of(buf[4 * n:5 * n].view(b, s, h * D), h)
    return [buf[i * 2 * n:i * 2 * n + n].view(b, h, s, D) for i in range(4)]


def _strides(*views):
    return sum((t.stride()[:3] for t in views), ())


@pytest.mark.parametrize("layout", ["views", "contiguous"])
def test_k5_passes_the_80_lane_views(entry, layout):
    b, s, h = 16, 392, 16
    q, k, v, do = _views(layout, b, s, h)
    if layout == "views":
        assert q.stride() == (s * 3 * h * D, D, 3 * h * D, 1)
    o, (m, l) = TA.grouped_fwd(q, k, v, SCALE, with_stats=True)
    assert o.shape == q.shape and o.stride() == TA._empty_like_rows(q).stride()
    dq, dk, dv = TA.grouped_bwd(q, k, v, do, m, l, SCALE)
    (l0, e0, a0), (l1, e1, a1), (l2, e2, a2) = entry
    assert (l0, e0) == ("short_attn_wgmma", "unite_short_grouped_fwd")
    assert a0[:6] == tuple(t.data_ptr() for t in (q, k, v, o, m, l))
    assert tuple(a0[6]) == _strides(q, k, v, o)
    assert a0[7:11] == (b, s, h, D)
    assert a0[11] == pytest.approx(SCALE * TA.INV_LN2) and a0[12] == 7
    assert (l1, e1) == ("short_bwd_wgmma", "unite_short_grouped_dq")
    assert (l2, e2) == ("short_bwd_wgmma", "unite_short_grouped_dkv")
    views = tuple(t.data_ptr() for t in (q, k, v, do))
    assert a1[:7] == views + (m.data_ptr(), l.data_ptr(), a1[6])
    assert a1[7] == dq.data_ptr()
    assert a2[:9] == views + (m.data_ptr(), l.data_ptr(), a1[6],
                              dk.data_ptr(), dv.data_ptr())
    assert tuple(a1[8]) == _strides(q, k, v, do, dq)
    assert tuple(a2[9]) == _strides(q, k, v, do, dk, dv)
    for args, at in ((a1, 9), (a2, 10)):
        assert args[at:at + 4] == (b, s, h, D)
        assert args[at + 4:] == (pytest.approx(SCALE * TA.INV_LN2),
                                 pytest.approx(SCALE), 7)
    assert [getattr(TA, n).launches for n in COUNTERS] == [0, 0, 0, 1, 1, 1]


@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("s", [632, 1569])
def test_k6_passes_the_80_lane_views(entry, layout, s):
    b, h = 2, 16
    q, k, v, do = _views(layout, b, s, h)
    o, lse = TA.flash_fwd(q, k, v, SCALE, with_lse=True)
    assert o.stride() == TA._empty_like_rows(q).stride()
    dq, dk, dv = TA.flash_bwd(q, k, v, o, lse, do, SCALE)
    (_, e0, a0), (_, e1, a1), (_, e2, a2) = entry
    assert (e0, e1, e2) == ENTRIES[:3]
    assert list(a0[:5]) == [t.data_ptr() for t in (q, k, v, o, lse)]
    assert tuple(a0[5]) == _strides(q, k, v, o)
    assert a0[6:10] == (b, s, h, D)
    delta = a1[6]
    assert list(a1[:8]) == [t.data_ptr() for t in (q, k, v, o, do, lse)] + [
        delta, dq.data_ptr()]
    assert tuple(a1[8]) == _strides(q, k, v, o, do, dq)
    assert list(a2[:8]) == [t.data_ptr() for t in (q, k, v, do, lse)] + [
        delta, dk.data_ptr(), dv.data_ptr()]
    assert tuple(a2[8]) == _strides(q, k, v, do, dk, dv)
    for args in (a1, a2):
        assert args[9:13] == (b, s, h, D)
        assert args[13:] == (pytest.approx(SCALE * TA.INV_LN2),
                             pytest.approx(SCALE), 7)
    assert [getattr(TA, n).launches for n in COUNTERS] == [1, 1, 1, 0, 0, 0]


def test_k5_forward_guard_at_80(entry):
    # a head's K and V of 512 keys at 80 lanes fill K5's forward (160 KB);
    # 768 keys fit only at 64 lanes
    assert TA.RESIDENT_MAX_SEQ[D] == TA.GROUPED_MAX_SEQ == 512
    for d, s, ok in ((D, 512, True), (D, 513, False), (64, 768, True),
                     (64, 769, False)):
        q = torch.empty((1, 2, s, d), dtype=torch.bfloat16, device="meta")
        if ok:
            TA.grouped_fwd(q, q, q, d ** -0.5)
            continue
        with pytest.raises(ValueError, match="K6"):
            TA.grouped_fwd(q, q, q, d ** -0.5)
    assert len(entry) == 2 and TA.grouped_fwd.launches == 2
    assert [a[10] for _, _, a in entry] == [D, 64]


def test_kernel_layout_copies_only_what_tma_cannot_take():
    b, s, h = 2, 392, 16
    rows = _views("views", b, s, h)[3]
    dense = torch.empty((b, h, s, D), dtype=torch.bfloat16, device="meta")
    for t in (rows, dense):  # 160-byte rows, strides multiples of 8
        assert TA._kernel_layout(t) is t
    # lanes 4..83 of 88-lane rows: 8 bytes past a 16-byte boundary
    wide = torch.empty((b, h, s, 88), dtype=torch.bfloat16, device="meta")
    shifted = wide[..., 4:84]
    assert shifted.data_ptr() % 16 == 8
    # 84-lane rows: 168 bytes, not a multiple of 16; a broadcast gradient
    odd = torch.empty((b, h, s, 84), dtype=torch.bfloat16,
                      device="meta")[..., :D]
    broadcast = torch.empty((1, 1, 1, D), dtype=torch.bfloat16,
                            device="meta").expand(b, h, s, D)
    for t in (shifted, odd, broadcast):
        c = TA._kernel_layout(t)
        assert c is not t and c.is_contiguous() and c.shape == (b, h, s, D)


# ------------------------------------------------- the VideoMAE model


P, TUBELET = 16, 2
CFG = dict(img_size=224, patch_size=P, encoder_embed_dim=640,
           encoder_depth=1, encoder_num_heads=8,
           decoder_num_classes=3 * TUBELET * P * P, decoder_embed_dim=640,
           decoder_depth=1, decoder_num_heads=8, tubelet_size=TUBELET)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _record_wrappers(monkeypatch):
    calls = []
    for name in ("fused_qkv_fwd", "fused_qkv_bwd", "grouped_fwd",
                 "grouped_bwd", "flash_fwd", "flash_bwd", "packed_flash_fwd",
                 "packed_flash_bwd"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("ratio,visible,kernel", [(0.5, 392, "grouped"),
                                                  (0.195, 632, "flash")])
def test_videomae_encoder_at_80_lanes_matches_jax(monkeypatch, ratio,
                                                  visible, kernel):
    """Forward, pixel loss and every gradient of an 8-frame model (784
    patches, 392 or 632 of them visible) with 80-lane heads: the encoder's
    attention takes K5's or K6's plain version in training, the decoder's
    K3/K4's (784 tokens have a divisor query block)."""
    frames, b = 8, 2
    cfg = dict(CFG, num_frames=frames)
    gen = TubeMaskingGenerator((frames // TUBELET, 14, 14), ratio)
    rng = np.random.default_rng(visible)
    vis, msk = teng.mask_indices(np.stack([gen(rng) for _ in range(b)]))
    assert vis.shape == (b, visible) and msk.shape == (b, 784 - visible)
    jm = jmae.PretrainVideoMAE(**cfg)
    params = _perturb(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, frames, 224, 224, 3)),
        jnp.asarray(vis[:1]), jnp.asarray(msk[:1]))["params"], 1)
    tm = tmae.PretrainVideoMAE(**cfg)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)

    uint8 = np.random.default_rng(5).integers(
        0, 256, (b, frames, 224, 224, 3), dtype=np.uint8)
    videos = jnorm.normalize_videos(jnp.asarray(uint8)).astype(jnp.float32)
    labels = jeng.masked_pixel_targets(videos, jnp.asarray(msk), P, TUBELET)

    def loss_fn(p):
        preds = jm.apply({"params": p}, videos, jnp.asarray(vis),
                         jnp.asarray(msk), False)
        return jnp.mean(jnp.square(preds - labels)), preds

    (jloss, jpreds), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tv = torch.from_numpy(np.array(videos))
    tvis, tmsk = torch.from_numpy(vis), torch.from_numpy(msk)
    wrappers = [getattr(TA, n) for n in COUNTERS]
    launches = [w.launches for w in wrappers]
    calls = _record_wrappers(monkeypatch)
    tm.train()
    preds = tm(tv, tvis, tmsk)
    loss = torch.mean(torch.square(
        preds - teng.masked_pixel_targets(tv, tmsk, P, TUBELET)))
    loss.backward()
    assert calls == [f"{kernel}_fwd", "packed_flash_fwd", "packed_flash_bwd",
                     f"{kernel}_bwd"]
    # the CPU takes the plain versions: no kernel launch is counted
    assert [w.launches for w in wrappers] == launches
    assert _rel(preds.detach().numpy(), jpreds) < 1e-5
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(ref) == set(got)
    for k in ref:
        assert (got[k] - ref[k]).norm() <= 1e-5 * ref[k].norm(), k
