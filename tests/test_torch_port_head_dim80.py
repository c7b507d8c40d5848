"""Head dim 80 in the packed kernels K1-K4, against unite_tpu on the CPU.

``pretrain_videomae_huge_patch16_224`` is the registered model whose heads
are 80 lanes wide: its encoder is 1280 wide with 16 heads and its decoder
640 wide with 8, both multiples of 128, so JAX runs it on its Pallas
kernels. Here, with inputs made by numpy from a seed:

* plain K1/K2 (``qkv_attention_reference``, ``_bwd``) at 8 heads x 80
  (width 640) against ``_fused_qkv_fwd`` / ``_fused_qkv_bwd`` and plain
  K3/K4 (``packed_flash_reference``, ``_bwd``) at S = 576 (query block 192)
  against ``_packed_flash_fwd`` / ``_packed_flash_bwd``, the Pallas
  kernels in interpret mode (``_INTERPRET`` and ``_on_tpu`` patched, as
  tests/test_kernel_interpret.py runs them). Tolerances are those of
  tests/test_torch_port_packed.py: fp32 rtol = atol = 1e-5, bf16 atol 2e-2
  on values scaled by max(1, max |ref|) (a few bf16 ulps);
* what the wrappers hand the C entry points at D = 80 (lane pointers,
  strides and the head dim), through a faked entry on meta tensors, which
  take the wrappers' CUDA path;
* the CUDA path's refusals: head dims other than 64 and 80 in K1-K6,
  K1/K2 past their shared-memory guard at 80 (K5 and K6 at head dim 80:
  tests/test_torch_port_view_head_dim80.py);
* a small ``PretrainVideoMAE`` with 80-lane heads in both towers (width
  640, 8 heads, depth 1 each) against JAX through utils/flax_bridge.py in
  fp32: forward, loss and every gradient within 1e-5 (relative to the
  reference's largest value, or to each gradient tensor's norm).

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

HEADS, D = 8, 80
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


# ------------------------------------------------------- K1/K2, K3/K4


def test_the_route_sends_the_huge_model_to_k1_k4():
    # encoder: 1280 wide at 160 visible tokens; decoder: 640 wide at 1568
    assert 1280 // 16 == 640 // 8 == D and D in TA.HEAD_DIMS
    assert TA.use_fused_qkv(160, False, 1280)
    assert TA.use_fused_qkv(1568, False, 640) and TA.packed_flash_ok(1568)
    assert TA.packed_flash_ok(576)  # the test length: query block 192
    assert TA.divisor_block(576, TA.PACKED_QBLOCK_MAX) == 192


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", [7, 160, 384])
def test_plain_k1_k2_match_pallas(interpret, s, dtype, tol):
    jdt = _jdt(dtype)
    jx = jnp.asarray(_rand((2, s, 3 * HEADS * D), s)).astype(jdt)
    jg = jnp.asarray(_rand((2, s, HEADS * D), 50 + s)).astype(jdt)
    out, res = A._fused_qkv_fwd(jx, HEADS, SCALE)
    assert res[2] is None  # K1 ran (no packed lse)
    tx = _torch(jx, dtype)
    tout, tlse = TA.fused_qkv_fwd(tx, HEADS, SCALE, with_lse=True)
    assert tout.shape == (2, s, HEADS * D) and tlse.shape == (2, HEADS, s)
    np.testing.assert_allclose(tout.float().numpy(), _np(out), **tol)
    ref = _np(A._fused_qkv_bwd(HEADS, SCALE, res, jg)[0])
    got = TA.fused_qkv_bwd(tx, tout, tlse, _torch(jg, dtype), HEADS, SCALE)
    assert got.dtype == _tdt(dtype) and got.shape == jx.shape
    np.testing.assert_allclose(*_scaled(got.float().numpy(), ref), **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_plain_k3_k4_match_pallas(interpret, dtype, tol):
    s, jdt = 576, _jdt(dtype)
    jx = jnp.asarray(_rand((2, s, 3 * HEADS * D), 7)).astype(jdt)
    jg = jnp.asarray(_rand((2, s, HEADS * D), 8)).astype(jdt)
    out, lse = A._packed_flash_fwd(jx, HEADS, SCALE)
    tout, tlse = TA.packed_flash_fwd(_torch(jx, dtype), HEADS, SCALE,
                                     with_lse=True)
    np.testing.assert_allclose(tout.float().numpy(), _np(out), **tol)
    # the TPU broadcasts lse over 8 sublanes; the port keeps [B, H, S]
    np.testing.assert_allclose(tlse.numpy(), _np(lse[..., 0]), rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 1e-3)
    ref = _np(A._packed_flash_bwd(jx, out, lse, jg, HEADS, SCALE))
    # the same out and lse on both sides
    got = TA.packed_flash_bwd(_torch(jx, dtype), _torch(out, dtype),
                              torch.from_numpy(_np(lse[..., 0])),
                              _torch(jg, dtype), HEADS, SCALE)
    assert got.dtype == _tdt(dtype) and got.shape == jx.shape
    np.testing.assert_allclose(*_scaled(got.float().numpy(), ref), **tol)


# ------------------------------------------------- what the entries get

ENTRIES = ("unite_short_qkv_fwd", "unite_short_qkv_bwd", "unite_flash_fwd",
           "unite_flash_dq", "unite_flash_dkv", "unite_short_grouped_fwd",
           "unite_short_grouped_dq", "unite_short_grouped_dkv")
COUNTERS = ("fused_qkv_fwd", "fused_qkv_bwd", "packed_flash_fwd",
            "packed_flash_dq", "packed_flash_dkv", "flash_fwd", "flash_dq",
            "flash_dkv", "grouped_fwd", "grouped_dq", "grouped_dkv")


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
    monkeypatch.setattr(TA.fused_qkv_fwd, "by_shape", type(
        TA.fused_qkv_fwd.by_shape)())
    monkeypatch.setattr(TA.packed_flash_fwd, "by_shape", type(
        TA.packed_flash_fwd.by_shape)())
    return calls


def _arena(dtype):
    """Slices of one meta buffer: tensors that take no memory, each with
    its own data pointer."""
    buf = torch.empty(1 << 30, dtype=dtype, device="meta")
    at = [64]

    def take(*shape):
        n = int(np.prod(shape))
        t = buf[at[0]:at[0] + n].view(*shape)
        at[0] += n + 64
        return t
    return take


@pytest.mark.parametrize("b,s,h", [(16, 160, 16), (2, 384, 8)])
def test_k1_k2_pass_the_80_lane_slices(entry, b, s, h):
    bf, f32 = _arena(torch.bfloat16), _arena(torch.float32)
    hd = h * D
    qkv, out, do = bf(b, s, 3 * hd), bf(b, s, hd), bf(b, s, hd)
    lse = f32(b, h, s)

    def lanes(t, *parts):
        return [t.data_ptr() + 2 * i * hd for i in parts]

    wide, narrow = (s * 3 * hd, D, 3 * hd), (s * hd, D, hd)
    got, got_lse = TA.fused_qkv_fwd(qkv, h, SCALE, with_lse=True)
    dqkv = TA.fused_qkv_bwd(qkv, out, lse, do, h, SCALE)
    (l1, e1, a1), (l2, e2, a2) = entry
    assert (l1, e1) == ("short_attn_wgmma", "unite_short_qkv_fwd")
    assert list(a1[:5]) == lanes(qkv, 0, 1, 2) + [got.data_ptr(),
                                                  got_lse.data_ptr()]
    assert list(a1[5]) == list(wide * 3 + narrow)
    assert a1[6:10] == (b, s, h, D)
    assert a1[10] == pytest.approx(SCALE * TA.INV_LN2) and a1[11] == 7
    assert (l2, e2) == ("short_bwd_wgmma", "unite_short_qkv_bwd")
    assert list(a2[:8]) == lanes(qkv, 0, 1, 2) + [
        out.data_ptr(), do.data_ptr()] + lanes(dqkv, 0, 1, 2)
    assert a2[8] == lse.data_ptr()
    assert list(a2[10]) == list(wide * 3 + narrow * 2 + wide * 3)
    assert a2[11:15] == (b, s, h, D)
    assert a2[15:] == (pytest.approx(SCALE * TA.INV_LN2),
                       pytest.approx(SCALE), 7)
    assert (TA.fused_qkv_fwd.launches, TA.fused_qkv_bwd.launches) == (1, 1)
    assert dict(TA.fused_qkv_fwd.by_shape) == {(b, s): 1}


@pytest.mark.parametrize("b,s,h", [(16, 1568, 8), (2, 576, 8)])
def test_k3_k4_pass_the_80_lane_slices(entry, b, s, h):
    bf, f32 = _arena(torch.bfloat16), _arena(torch.float32)
    hd = h * D
    qkv, dqkv = bf(b, s, 3 * hd), bf(b, s, 3 * hd)
    out, do = bf(b, s, hd), bf(b, s, hd)
    lse, delta = f32(b, h, s), f32(b, h, s)

    def lanes(t, *parts):
        return [t.data_ptr() + 2 * i * hd for i in parts]

    wide, narrow = (s * 3 * hd, D, 3 * hd), (s * hd, D, hd)
    o, _ = TA.packed_flash_fwd(qkv, h, SCALE)
    TA.packed_flash_dq(qkv, out, lse, do, dqkv, delta, h, SCALE)
    TA.packed_flash_dkv(qkv, do, lse, delta, dqkv, h, SCALE)
    (_, e0, a0), (_, e1, a1), (_, e2, a2) = entry
    assert (e0, e1, e2) == ("unite_flash_fwd", "unite_flash_dq",
                            "unite_flash_dkv")
    assert list(a0[:5]) == lanes(qkv, 0, 1, 2) + [o.data_ptr(), None]
    assert list(a0[5]) == list(wide * 3 + narrow)
    assert a0[6:10] == (b, s, h, D)
    assert list(a1[:8]) == lanes(qkv, 0, 1, 2) + [
        out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr()] \
        + lanes(dqkv, 0)
    assert list(a1[8]) == list(wide * 3 + narrow * 2 + wide)
    assert list(a2[:8]) == lanes(qkv, 0, 1, 2) + [
        do.data_ptr(), lse.data_ptr(), delta.data_ptr()] + lanes(dqkv, 1, 2)
    assert list(a2[8]) == list(wide * 3 + narrow + wide * 2)
    for args in (a1, a2):
        assert args[9:13] == (b, s, h, D)
        assert args[13:] == (pytest.approx(SCALE * TA.INV_LN2),
                             pytest.approx(SCALE), 7)
    assert (TA.packed_flash_fwd.launches, TA.packed_flash_dq.launches,
            TA.packed_flash_dkv.launches) == (1, 1, 1)


@pytest.mark.parametrize("d", [32, 72, 96, 128])
def test_cuda_path_refuses_other_head_dims(entry, d):
    # K1-K4 take 64 and 80; a CUDA tensor never takes the plain version
    h, s = 2, 600
    qkv = torch.empty((1, s, 3 * h * d), dtype=torch.bfloat16, device="meta")
    out = torch.empty((1, s, h * d), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, h, s), dtype=torch.float32, device="meta")
    short = qkv[:, :160].contiguous()
    calls = (lambda: TA.fused_qkv_fwd(short, h, SCALE),
             lambda: TA.fused_qkv_bwd(short, out[:, :160].contiguous(),
                                      lse[..., :160].contiguous(),
                                      out[:, :160].contiguous(), h, SCALE),
             lambda: TA.packed_flash_fwd(qkv, h, SCALE),
             lambda: TA.packed_flash_bwd(qkv, out, lse, out, h, SCALE),
             lambda: TA.fused_qkv_attention(qkv, h, SCALE))
    for call in calls:
        with pytest.raises(ValueError, match=r"head dims \(64, 80\)"):
            call()
    assert entry == []
    assert all(getattr(TA, n).launches == 0 for n in COUNTERS)


@pytest.mark.parametrize("d", [32, 72, 96, 128])
def test_k5_k6_refuse_other_head_dims_on_cuda(entry, d):
    # the [B, H, S, D] kernels take 64 and 80 as K1-K4 do; a CUDA tensor of
    # another head dim raises and never takes the plain version
    b, h = 2, 8
    for s, fwd, bwd in ((392, TA.grouped_fwd, TA.grouped_bwd),
                        (1569, TA.flash_fwd, TA.flash_bwd)):
        q = torch.empty((b, h, s, d), dtype=torch.bfloat16, device="meta")
        stats = torch.empty((b, h, s), dtype=torch.float32, device="meta")
        with pytest.raises(ValueError, match=r"head dims \(64, 80\)"):
            fwd(q, q, q, d ** -0.5)
        with pytest.raises(ValueError, match=r"head dims \(64, 80\)"):
            if fwd is TA.grouped_fwd:
                bwd(q, q, q, q, stats, stats, d ** -0.5)
            else:
                bwd(q, q, q, q, stats, q, d ** -0.5)
        with pytest.raises(ValueError, match=r"head dims \(64, 80\)"):
            TA.multi_head_attention(q, q, q, scale=d ** -0.5)
    assert entry == []
    assert all(getattr(TA, n).launches == 0 for n in COUNTERS)


def test_k1_k2_guard_at_head_dim_80(entry):
    # 80 lanes take 160 bytes a row: K1's K and V fit up to 512 keys
    assert TA.RESIDENT_MAX_SEQ == {64: TA.FUSED_QKV_MAX_SEQ, 80: 512}
    assert TA.RESIDENT_MAX_SEQ[80] >= TA.FUSED_QKV_FWD_MAX_SEQ
    assert TA.RESIDENT_MAX_SEQ[80] >= TA.FUSED_QKV_TRAIN_MAX_SEQ
    h = 2
    for s, ok in ((512, True), (513, False)):
        qkv = torch.empty((1, s, 3 * h * D), dtype=torch.bfloat16,
                          device="meta")
        if ok:
            TA.fused_qkv_fwd(qkv, h, SCALE)
            continue
        with pytest.raises(ValueError, match="K3"):
            TA.fused_qkv_fwd(qkv, h, SCALE)
    assert len(entry) == 1 and TA.fused_qkv_fwd.launches == 1


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


def _masks(b, frames, seed):
    gen = TubeMaskingGenerator((frames // TUBELET, 14, 14), 0.9)
    rng = np.random.default_rng(seed)
    return teng.mask_indices(np.stack([gen(rng) for _ in range(b)]))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_videomae_with_80_lane_heads_matches_jax():
    """Forward, pixel loss and every gradient of a 4-frame model (40
    visible tokens through K1/K2's plain versions, 392 in the decoder)."""
    frames = 4
    cfg = dict(CFG, num_frames=frames)
    jm = jmae.PretrainVideoMAE(**cfg)
    vis, msk = _masks(2, frames, 4)
    assert vis.shape == (2, 40) and msk.shape == (2, 352)
    params = _perturb(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, frames, 224, 224, 3)),
        jnp.asarray(vis[:1]), jnp.asarray(msk[:1]))["params"], 1)
    tm = tmae.PretrainVideoMAE(**cfg)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    assert tm.encoder.blocks[0].attn.num_heads == 8
    assert tm.decoder.blocks[0].attn.num_heads == 8

    uint8 = np.random.default_rng(5).integers(
        0, 256, (2, frames, 224, 224, 3), dtype=np.uint8)
    # the JAX normalization's values, fp32 on both sides
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
    tm.train()
    preds = tm(tv, tvis, tmsk)
    tlabels = teng.masked_pixel_targets(tv, tmsk, P, TUBELET)
    loss = torch.mean(torch.square(preds - tlabels))
    loss.backward()
    assert preds.shape == (2, 352, 3 * TUBELET * P * P)
    assert _rel(preds.detach().numpy(), jpreds) < 1e-5
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(ref) == set(got)
    for k in ref:
        assert (got[k] - ref[k]).norm() <= 1e-5 * ref[k].norm(), k
