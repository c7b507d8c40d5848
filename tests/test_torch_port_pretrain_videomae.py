"""unite_torch VideoMAE model and pixel-reconstruction step against
unite_tpu, fp32 on the CPU.

The tiny model keeps the card's routes: head dim 64 (width 128, 2 heads)
and 8 frames of 224^2 with tubelet 2, so the encoder runs 80 visible
tokens on the packed-qkv route (K1/K2's plain versions) and the decoder
784 tokens on the packed flash route (K3/K4's plain versions, query block
112). Masks are tube masks drawn per clip, so visible and masked positions
differ between the clips of a batch; weights go through the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.engines import pretrain_videomae as jeng
from unite_tpu.models import pretrain_videomae as jmae
from unite_tpu.ops import normalize as jnorm
from unite_tpu.optim import factory as jfactory
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_torch.engines import pretrain_videomae as teng
from unite_torch.models import pretrain_videomae as tmae
from unite_torch.ops.attention import packed_flash_ok, use_fused_qkv
from unite_torch.ops.masking import TubeMaskingGenerator
from unite_torch.optim import factory as tfactory
from unite_torch.train.train_state import TrainState
from unite_torch.utils.flax_bridge import flax_to_state_dict
from unite_torch.utils.registry import create_model, list_models

FRAMES, TUBELET, P = 8, 2, 16
GRID = (FRAMES // TUBELET, 14, 14)  # 784 tokens
CFG = dict(img_size=224, patch_size=P, encoder_embed_dim=128,
           encoder_depth=2, encoder_num_heads=2,
           decoder_num_classes=3 * TUBELET * P * P, decoder_embed_dim=128,
           decoder_depth=2, decoder_num_heads=2, num_frames=FRAMES,
           tubelet_size=TUBELET)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def tube_masks(b, seed, ratio=0.9):
    """Per-clip tube masks -> (vis_idx, mask_idx) int64."""
    gen = TubeMaskingGenerator(GRID, ratio)
    rng = np.random.default_rng(seed)
    return teng.mask_indices(np.stack([gen(rng) for _ in range(b)]))


def uint8_videos(b, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (b, FRAMES, 224, 224, 3), dtype=np.uint8)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_mask_indices_split_one_argsort():
    vis, msk = tube_masks(2, 0)
    assert vis.shape == (2, 4 * 20) and msk.shape == (2, 4 * 176)
    assert not np.array_equal(vis[0], vis[1])  # per clip
    for v, m in zip(vis, msk):
        assert np.array_equal(np.sort(np.concatenate([v, m])), np.arange(784))
        assert np.all(np.diff(v) > 0) and np.all(np.diff(m) > 0)


def test_patchify_and_targets_match_jax():
    x = np.random.default_rng(1).standard_normal(
        (2, FRAMES, 64, 48, 3)).astype(np.float32)
    gen = TubeMaskingGenerator((FRAMES // TUBELET, 4, 3), 0.5)
    rng = np.random.default_rng(2)
    _, msk = teng.mask_indices(np.stack([gen(rng) for _ in range(2)]))
    np.testing.assert_allclose(
        teng.patchify(torch.from_numpy(x), P, TUBELET).numpy(),
        np.asarray(jeng.patchify(jnp.asarray(x), P, TUBELET)), rtol=0,
        atol=1e-6)
    for norm in (True, False):
        got = teng.masked_pixel_targets(torch.from_numpy(x),
                                        torch.from_numpy(msk), P, TUBELET,
                                        norm)
        ref = jeng.masked_pixel_targets(jnp.asarray(x), jnp.asarray(msk), P,
                                        TUBELET, norm)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


def _pair(seed=0):
    jm = jmae.PretrainVideoMAE(**CFG)
    x = jnp.zeros((1, FRAMES, 224, 224, 3))
    vis, msk = tube_masks(1, 99)
    p = perturb(jm.init(jax.random.PRNGKey(seed), x, jnp.asarray(vis),
                        jnp.asarray(msk))["params"], seed + 1)
    tm = tmae.PretrainVideoMAE(**CFG)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    return jm, p, tm


def test_route_is_the_cards():
    # encoder: 80 visible tokens at width 128 -> K1/K2; decoder: 784 -> K3/K4
    assert use_fused_qkv(80, False, 128)
    assert use_fused_qkv(784, False, 128) and packed_flash_ok(784)


def test_forward_matches_jax():
    jm, p, tm = _pair()
    x = np.random.default_rng(3).standard_normal(
        (2, FRAMES, 224, 224, 3)).astype(np.float32)
    vis, msk = tube_masks(2, 4)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(vis),
                        torch.from_numpy(msk))
    ref = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(vis),
                   jnp.asarray(msk))
    assert got.shape == (2, 704, 1536) and got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) < 1e-5


def test_bf16_decoder_head_is_fp32():
    tm = tmae.PretrainVideoMAE(**CFG, dtype=torch.bfloat16)
    x = torch.from_numpy(uint8_videos(1, 5)).float()
    vis, msk = tube_masks(1, 6)
    out = tm.decoder.head(torch.ones(1, 2, 128, dtype=torch.bfloat16))
    assert out.dtype == torch.float32
    with torch.no_grad():
        y = tm.eval()(x, torch.from_numpy(vis), torch.from_numpy(msk))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


def test_train_steps_match_jax():
    """Three fp32 steps of AdamW (eps 1e-6, drop path 0, wd 0.05, clip 0.5):
    losses, grad norms and every parameter within 1e-5 of each tensor's
    norm."""
    jm, p, tm = _pair(seed=7)
    lr, wd, eps, betas, clip = 1e-3, 0.05, 1e-6, (0.9, 0.95), 0.5
    tx, _ = jfactory.create_optimizer("adamw", lr=lr, params=p,
                                      weight_decay=wd, betas=betas, eps=eps)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, p), tx)
    jstep = jax.jit(jeng.make_videomae_train_step(
        jm, patch_size=P, tubelet_size=TUBELET, clip_grad=clip))
    opt, _ = tfactory.create_optimizer("adamw", lr, tm, weight_decay=wd,
                                       betas=betas, eps=eps, device="cpu")
    state = TrainState(tm, opt)
    step = teng.make_videomae_train_step(tm, patch_size=P,
                                         tubelet_size=TUBELET,
                                         clip_grad=clip, device="cpu")
    for i in range(3):
        vids = uint8_videos(2, 20 + i)
        vis, msk = tube_masks(2, 30 + i)
        jstate, jmet = jstep(jstate, {
            "videos": jnorm.normalize_videos(jnp.asarray(vids)),
            "vis_idx": jnp.asarray(vis), "mask_idx": jnp.asarray(msk)},
            jax.random.PRNGKey(0))
        met = step(state, {"videos": torch.from_numpy(vids),
                           "vis_idx": torch.from_numpy(vis),
                           "mask_idx": torch.from_numpy(msk)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
        got = tm.state_dict()
        assert set(ref) == set(got)
        for k in ref:
            assert (got[k] - ref[k]).norm() <= 1e-5 * ref[k].norm(), (i, k)
    assert state.step == 3 and opt.count == 3


def test_registry_lists_the_jax_names():
    from unite_tpu.utils.registry import list_models as jax_models

    want = {n for n in jax_models() if n.startswith("pretrain_")}
    assert want == {n for n in list_models() if n.startswith("pretrain_")}
    assert len(want) == 5


@pytest.mark.parametrize("size,width,depth,dec", [
    ("base", 768, 12, 384), ("large", 1024, 24, 512), ("huge", 1280, 32, 640)])
def test_factories_match_jax_geometry(size, width, depth, dec):
    name = f"pretrain_videomae_{size}_patch16_224"
    m = create_model(name, device="meta")
    jm = jmae.__dict__[name]()
    assert len(m.encoder.blocks) == depth == jm.encoder_depth
    assert m.encoder.norm.weight.shape == (width,)
    assert m.encoder_to_decoder.weight.shape == (dec, width)
    assert len(m.decoder.blocks) == jm.decoder_depth == 8
    assert m.decoder.head.weight.shape == (1536, dec)
    assert m.decoder.blocks[0].attn.num_heads == jm.decoder_num_heads
