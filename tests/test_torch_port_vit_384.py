"""unite_torch's 384 ViTs against unite_tpu's, on the CPU.

``vit_base_patch16_384`` (12 blocks of 768, 12 heads of 64) and
``vit_large_patch16_384`` (24 blocks of 1024, 16 heads of 64) finetune at
8 frames of 384^2 with tubelet 1: 24^2 x 8 = 4608 tokens, a length with a
divisor query block (192), so both packages take the packed flash route
(K3/K4); with a CLS readout the sequence is 4609 tokens, which has none,
and both take the [B, H, S, D] flash route (K6).

* The route predicate equals JAX's at every length 1-4609, at the two
  widths, in training and forward-only.
* The full-size models are compared by names and shapes only: the port
  builds them on ``meta`` from the stage-2 entry's parser and
  ``build_model``, JAX traces its ``init`` under ``jax.eval_shape``, and
  both bridges map every leaf onto the port's keys.
* A narrow 384 ViT (2 blocks, 2 heads of 64, 8 frames, B=1) gives the
  numbers in fp32: eval logits and one finetune step's loss, grad norm and
  updated parameters within 1e-5 relative of JAX's, with mean pooling (the
  plain K3/K4 on the CPU) and with the CLS token (the plain K6).
* The plain K3/K4 at [1, 4608, 3*2*64] in bf16 against the Pallas
  kernels in interpret mode, at the bf16 tolerance of
  tests/test_torch_port_packed.py (2e-2 absolute over max(1, max |ref|)).
* ``interpolate_pos_embed`` from a 224 checkpoint's 14^2 grid to 24^2 and
  from 8 to 16 frames, with 0 and 1 extra tokens, bit for bit.
* The finetune dataset's items at ``crop_size=384, short_side_size=384``
  from 340x256 clips (up-scaled to a short side of 384), bit for bit, and
  the device validation transform at (384, 384) within 1e-5.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA
from unite_tpu.config import parse_with_config as jparse
from unite_tpu.data import datasets as jds
from unite_tpu.data import video_reader as jreader
from unite_tpu.engines import finetune as jft
from unite_tpu.models import vit as jvit
from unite_tpu.ops import eval_transforms as jev
from unite_tpu.optim import factory as jfactory
from unite_tpu.train import args as jargs
from unite_tpu.train import run_stage2 as jrun2
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_tpu.utils import torch_import as jti
from unite_tpu.utils.torch_export import flax_path_to_torch
from unite_torch.config import parse_with_config
from unite_torch.data import datasets as tds
from unite_torch.data import video_reader as treader
from unite_torch.engines import finetune as tft
from unite_torch.models import vit as tvit
from unite_torch.ops import eval_transforms as tev
from unite_torch.optim import factory as tfactory
from unite_torch.train import run_stage2 as trun2
from unite_torch.train.args import stage2_parser
from unite_torch.train.train_state import TrainState
from unite_torch.utils import torch_import as tti
from unite_torch.utils.flax_bridge import flax_to_state_dict, student_key

ROOT = Path(__file__).resolve().parents[1]
TOKENS = 8 * (384 // 16) ** 2  # 4608
SCALE = 64 ** -0.5


# ------------------------------------------------------------------ route

@pytest.mark.parametrize("fwd_only", [False, True])
@pytest.mark.parametrize("dim", [768, 1024])
def test_route_at_every_length_to_4609_equals_jax(fwd_only, dim):
    for s in range(1, TOKENS + 2):
        assert TA.use_fused_qkv(s, fwd_only, dim) == A.use_fused_qkv(
            s, True, fwd_only=fwd_only, dim=dim), (s, fwd_only, dim)
        assert TA.packed_flash_ok(s) == A._packed_flash_ok(s), s
    # 4608 = 24 x 192: the packed route; 4609 (with CLS) has no divisor
    # block and goes to multi_head_attention, whose kernel above 512 is K6
    assert TA.divisor_block(TOKENS, TA.PACKED_QBLOCK_MAX) == 192
    assert TA.use_fused_qkv(TOKENS, fwd_only, dim)
    assert not TA.use_fused_qkv(TOKENS + 1, fwd_only, dim)
    assert TOKENS + 1 > TA.GROUPED_MAX_SEQ


# ------------------------------------------------- full-size models, shapes

def _stand_ins(shapes):
    """Zero-stride numpy arrays of ``jax.eval_shape``'s shapes."""
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("pooling", ["true", "false"])
@pytest.mark.parametrize("name,width,depth,heads", [
    ("vit_base_patch16_384", 768, 12, 12),
    ("vit_large_patch16_384", 1024, 24, 16)])
def test_full_size_384_vit_builds_as_jax_on_meta(name, width, depth, heads,
                                                 pooling):
    argv = ["--config", str(ROOT / "configs/stage2_config.yaml"),
            "--model", name, "--input_size", "384", "--short_side_size",
            "384", "--use_mean_pooling", pooling]
    args = parse_with_config(stage2_parser(), argv)
    jargs_ = jparse(jargs.stage2_parser(), argv)
    assert args.num_frames == 8 and args.tubelet_size == 1
    model = trun2.build_model(args, device="meta")
    shapes = jax.eval_shape(
        jrun2.build_model(jargs_).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 8, 384, 384, 3), jnp.float32))["params"]
    state = model.state_dict()
    assert all(v.device.type == "meta" for v in state.values())
    mapped = {}
    for path, arr in _paths(_stand_ins(shapes)):
        key, val = student_key(path, arr, 16)
        # JAX's own bridge (torch_export.flax_params_to_state's leaf map)
        # names the same key with the same shape
        jkey, jval = flax_path_to_torch(path, arr, patch_size=16)
        assert (jkey, tuple(jval.shape)) == (key, tuple(val.shape)), path
        mapped[key] = tuple(val.shape)
    params = dict(model.named_parameters())
    assert set(params) <= set(mapped) <= set(state), \
        (set(params) - set(mapped), set(mapped) - set(state))
    for key, shape in mapped.items():
        assert tuple(state[key].shape) == shape, key
    extra = pooling == "false"
    assert sum(int(np.prod(s)) for s in mapped.values()) == sum(
        p.numel() for p in params.values())
    assert model.depth == depth and len(model.blocks) == depth
    assert model.blocks[0].attn.num_heads == heads
    assert model.pos_embed.shape == (1, TOKENS + extra, width)
    assert ("cls_token" in mapped) == extra
    assert model.head.weight.shape == (12, width)


# ------------------------------------------------ narrow 384 ViT, numbers

NARROW = dict(img_size=384, patch_size=16, num_classes=12, embed_dim=128,
              depth=2, num_heads=2, all_frames=8, tubelet_size=1,
              init_scale=0.001)
FREEZE = SimpleNamespace(frozen_layers="0", train_head_only=False,
                         freeze_patch_embedding=False)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def close(a, b, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(a).detach().float()),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _spy(monkeypatch):
    """Names of the port's attention entry points as the model calls them
    (on the CPU each runs its kernel's plain version)."""
    calls = []
    for name in ("fused_qkv_fwd", "packed_flash_fwd", "packed_flash_bwd",
                 "flash_fwd", "flash_bwd", "grouped_fwd", "grouped_bwd"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("pooling,route", [
    (True, ["packed_flash_fwd", "packed_flash_bwd"]),
    (False, ["flash_fwd", "flash_bwd"])])
def test_narrow_384_vit_logits_and_step_match_jax(monkeypatch, pooling,
                                                  route):
    cfg = dict(NARROW, use_mean_pooling=pooling)
    jm = jvit.VisionTransformer(**cfg)
    rng = np.random.default_rng(0)
    vids = rng.integers(0, 256, (1, 8, 384, 384, 3), dtype=np.uint8)
    labels = np.array([5], np.int32)
    p = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8, 384, 384, 3)))["params"], 1)
    tm = tvit.VisionTransformer(**cfg)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    assert tm.pos_embed.shape[1] == TOKENS + (not pooling)
    calls = _spy(monkeypatch)

    # eval logits
    x = np.asarray(vids, np.float32) / 64.0 - 2.0
    ref = jax.jit(lambda q, v: jm.apply({"params": q}, v, True))(
        p, jnp.asarray(x))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    assert out.shape == (1, 12) and calls == [route[0]] * 2
    close(out, ref, atol=1e-6)

    # one finetune step: loss, grad norm, every updated parameter
    lr_tab = jsched.cosine_scheduler(5e-4, 1e-5, 1, 2)
    wd_tab = jsched.cosine_scheduler(0.05, 0.05, 1, 2)
    eps = 1e-6  # as tests/test_torch_port_finetune.py's gate
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr_tab, params=p, weight_decay=wd_tab,
        betas=(0.9, 0.999), eps=eps, num_layers=2, layer_decay=0.65,
        trainable_mask=jrun2.trainable_mask(FREEZE, p))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, p), tx)
    jstate, jm_ = jax.jit(jft.make_finetune_train_step(jm))(
        jstate, {"videos": jnp.asarray(vids), "labels": jnp.asarray(labels)},
        jax.random.PRNGKey(0))
    mask = trun2.trainable_mask(FREEZE, tm)
    opt, _ = tfactory.create_optimizer(
        "adamw", lr_tab, tm, weight_decay=wd_tab, betas=(0.9, 0.999),
        eps=eps, trainable=mask.__getitem__, num_layers=tm.depth,
        layer_decay=0.65, device="cpu")
    state = TrainState(tm.train(), opt)
    prev = {k: v.clone() for k, v in tm.state_dict().items()}
    calls.clear()
    m = tft.make_finetune_train_step(tm, device="cpu")(
        state, {"videos": torch.from_numpy(vids),
                "labels": torch.from_numpy(labels)})
    assert calls == [route[0]] * 2 + [route[1]] * 2
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm_[k]), rtol=1e-5,
                                   err_msg=k)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    got = tm.state_dict()
    assert set(ref) == set(got)
    for k in ref:
        close(got[k], ref[k], err_msg=k)
        d_got, d_ref = got[k] - prev[k], ref[k] - prev[k]
        assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm() + 1e-9, k
    assert state.step == 1


# --------------------------------------------- plain K3/K4 against Pallas

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(A, "_on_tpu", lambda: True)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _scaled(a, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    return a / scale, ref / scale


def test_plain_k3_k4_at_4608_match_pallas_in_bf16(interpret):
    heads, tol = 2, dict(rtol=0, atol=2e-2)
    rng = np.random.default_rng(46)
    x = rng.standard_normal((1, TOKENS, 3 * heads * 64)).astype(np.float32)
    g = rng.standard_normal((1, TOKENS, heads * 64)).astype(np.float32)
    jx, jg = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, g))
    out, lse = A._packed_flash_fwd(jx, heads, SCALE)
    tx = torch.from_numpy(_np(jx)).to(torch.bfloat16)
    tout, tlse = TA.packed_flash_fwd(tx, heads, SCALE, with_lse=True)
    assert tout.shape == (1, TOKENS, heads * 64)
    np.testing.assert_allclose(tout.float().numpy(), _np(out), **tol)
    # the TPU broadcasts lse over 8 sublanes; the port keeps [B, H, S]
    np.testing.assert_allclose(tlse.numpy(), _np(lse[..., 0]), rtol=1e-5,
                               atol=1e-3)
    ref = _np(A._packed_flash_bwd(jx, out, lse, jg, heads, SCALE))
    got = TA.packed_flash_bwd(tx, torch.from_numpy(_np(out)).to(
        torch.bfloat16), torch.from_numpy(_np(lse[..., 0])),
        torch.from_numpy(_np(jg)).to(torch.bfloat16), heads, SCALE)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    np.testing.assert_allclose(*_scaled(got.float().numpy(), ref), **tol)


# ------------------------------------------------ positional embeddings

@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("what,kw,rows", [
    # a 224 checkpoint (14^2 a frame) finetuned at 384 (24^2)
    ("spatial 14 -> 24", dict(num_patches=8 * 576, new_frames=8), 8 * 196),
    # 8 frames to 16
    ("temporal 8 -> 16", dict(num_patches=16 * 196, new_frames=16), 8 * 196)])
def test_interpolate_pos_embed_to_384_matches_jax(what, kw, rows, extra):
    pe = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, extra + rows, 24)).astype(np.float32))
    args = dict(kw, num_extra_tokens=extra, tubelet_size=1,
                key="encoder.pos_embed")
    got = tti.interpolate_pos_embed({"encoder.pos_embed": pe.clone()},
                                    **args)["encoder.pos_embed"]
    ref = jti.interpolate_pos_embed({"encoder.pos_embed": pe.clone()},
                                    **args)["encoder.pos_embed"]
    assert got.shape == (1, extra + kw["num_patches"], 24), what
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    if extra:  # the CLS row is carried, not resampled
        assert torch.equal(got[:, :1], pe[:, :1])


# ------------------------------------------------------ the data path

def _same(got, ref):
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for a, b in zip(got, ref):
            _same(a, b)
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_finetune_items_at_384_match_jax(tmp_path, mode):
    anno = tmp_path / "a.csv"
    anno.write_text("".join(f"video_{i:03d}.mp4,{i % 5}\n" for i in range(3)))
    kw = dict(mode=mode, sep=",", clip_len=8, crop_size=384,
              short_side_size=384, test_num_segment=4, test_num_crop=3,
              aa="rand-m7-n4-mstd0.5-inc1", reprob=0.25, seed=3)
    port = tds.VideoClsDatasetSparse(
        str(anno), reader=treader.SyntheticVideoReader(256, 340), **kw)
    ref = jds.VideoClsDatasetSparse(
        str(anno), reader=jreader.SyntheticVideoReader(256, 340), **kw)
    assert len(port) == len(ref)
    port.set_epoch(1)
    ref.set_epoch(1)
    for i in (0, len(ref) - 1):
        got, want = port[i], ref[i]
        _same(got, want)
        assert want[0].shape[-3:-1] == (384, 384)


def test_device_val_transform_at_384_matches_jax():
    v = np.random.default_rng(12).integers(0, 256, (2, 2, 256, 340, 3),
                                           dtype=np.uint8)
    ref = np.asarray(jev.device_val_transform(jnp.asarray(v), 384, 384,
                                              jnp.float32))
    got = tev.make_device_val_transform(384, 384, torch.float32)(
        torch.from_numpy(v))
    assert tuple(got.shape) == ref.shape and ref.shape[2:4] == (384, 384)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
