"""unite_torch's VideoMAE-L and UMT-L pretraining models against
unite_tpu's, fp32 on the CPU.

``pretrain_videomae_large_patch16_224`` (24 encoder blocks of 1024 with 16
heads of 64, 8 decoder blocks of 512 with 8 heads of 64) pretrains on 16
frames of 224^2 with tubelet 2 at tube mask 0.9: 160 visible tokens on the
packed-qkv route (K1/K2) and 1568 decoder tokens on the packed flash route
(K3/K4). ``pretrain_umt_large_patch16_224`` runs 8 frames with tubelet 1
at tube mask 0.8: 320 visible tokens on K1/K2, with its CLIP decoders
1024 -> 768 (``clip_l14``'s output width).

* Numbers come from the two models at full width cut to a few blocks: the
  VideoMAE-L forward and two pixel-reconstruction steps, the UMT-L
  student's x_clip and the gradients of sum((out - t)^2) against seeded
  targets, each within 1e-5 relative of JAX's (on the CPU the port's
  attention wrappers run their kernels' plain versions, JAX its XLA path).
* The full-depth models are compared by names and shapes only: the port
  builds them on ``meta``, JAX traces its ``init`` under
  ``jax.eval_shape``, and both bridges map every leaf onto the port's keys.
* ``PretrainUMT``'s ``clip_decoder_embed_dim`` defaults to 768, so the
  large factory under its defaults adds a 1024-wide tap to a 768-wide
  positional table and fails its forward in both packages.
* The route at the two models' lengths and widths equals JAX's dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA
from unite_tpu.engines import pretrain_videomae as jeng
from unite_tpu.models import pretrain_umt as jumt
from unite_tpu.models import pretrain_videomae as jmae
from unite_tpu.ops import normalize as jnorm
from unite_tpu.optim import factory as jfactory
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils.torch_export import flax_path_to_torch
from unite_torch.engines import pretrain_videomae as teng
from unite_torch.models import pretrain_umt as tumt
from unite_torch.models import pretrain_videomae as tmae
from unite_torch.ops.masking import TubeMaskingGenerator
from unite_torch.optim import factory as tfactory
from unite_torch.train.train_state import TrainState
from unite_torch.utils.flax_bridge import flax_to_state_dict, student_key
from unite_torch.utils.registry import create_model

# the large factories' geometry (both packages); the depths are cut below
VMAE_L = dict(img_size=224, patch_size=16, encoder_embed_dim=1024,
              encoder_num_heads=16, decoder_num_classes=1536,
              decoder_embed_dim=512, decoder_num_heads=8, mlp_ratio=4,
              qkv_bias=True, norm_eps=1e-6, num_frames=16, tubelet_size=2)
UMT_L = dict(img_size=224, patch_size=16, encoder_embed_dim=1024,
             encoder_num_heads=16, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
             num_frames=8, tubelet_size=1, clip_decoder_embed_dim=1024,
             clip_output_dim=768)
MAE_GRID, MAE_MASK = (8, 14, 14), 0.9  # 1568 patches, 160 visible
UMT_GRID, UMT_MASK = (8, 14, 14), 0.8  # 1568 patches, 320 visible
P, TUBELET = 16, 2


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def tube_masks(b, seed, grid, ratio):
    """Per-clip tube masks -> (vis_idx, mask_idx) int64."""
    gen = TubeMaskingGenerator(grid, ratio)
    rng = np.random.default_rng(seed)
    return teng.mask_indices(np.stack([gen(rng) for _ in range(b)]))


def uint8_videos(b, seed, frames):
    return np.random.default_rng(seed).integers(
        0, 256, (b, frames, 224, 224, 3), dtype=np.uint8)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def within_norm(got: dict, ref: dict, what: str):
    """Every tensor within 1e-5 of the norm of JAX's."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k in ref:
        assert (got[k] - ref[k]).norm() <= 1e-5 * ref[k].norm(), (what, k)


# ---------------------------------------------- VideoMAE-L, 2 + 1 blocks

@pytest.fixture(scope="module")
def vmae_pair():
    cfg = dict(VMAE_L, encoder_depth=2, decoder_depth=1)
    jm = jmae.PretrainVideoMAE(**cfg)
    vis, msk = tube_masks(1, 99, MAE_GRID, MAE_MASK)
    p = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16, 224, 224, 3)),
                                 jnp.asarray(vis), jnp.asarray(msk))["params"],
                1)

    def port():
        tm = tmae.PretrainVideoMAE(**cfg)
        tm.load_state_dict(flax_to_state_dict(p), strict=True)
        return tm

    return jm, p, port


def test_videomae_l_forward_matches_jax(vmae_pair):
    jm, p, port = vmae_pair
    tm = port()
    assert tm.encoder.blocks[0].attn.num_heads == 16
    assert tm.decoder.blocks[0].attn.num_heads == 8
    x = np.random.default_rng(3).standard_normal(
        (2, 16, 224, 224, 3)).astype(np.float32)
    vis, msk = tube_masks(2, 4, MAE_GRID, MAE_MASK)
    assert vis.shape == (2, 160) and not np.array_equal(vis[0], vis[1])
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(vis),
                        torch.from_numpy(msk))
    ref = jax.jit(lambda q, v, i, j: jm.apply({"params": q}, v, i, j))(
        p, jnp.asarray(x), jnp.asarray(vis), jnp.asarray(msk))
    assert got.shape == (2, 1568 - 160, 1536) and got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) < 1e-5


def test_videomae_l_train_steps_match_jax(vmae_pair):
    """Two fp32 steps of AdamW (betas 0.9/0.95, eps 1e-6, wd 0.05, clip
    0.5): losses, grad norms and every parameter within 1e-5 of each
    tensor's norm."""
    jm, p, port = vmae_pair
    tm = port()
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
    for i in range(2):
        vids = uint8_videos(2, 20 + i, 16)
        vis, msk = tube_masks(2, 30 + i, MAE_GRID, MAE_MASK)
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
        within_norm(tm.state_dict(), flax_to_state_dict(
            jax.tree.map(np.asarray, jstate.params)), f"step {i}")
    assert state.step == 2 and opt.count == 2


# ----------------------------------------------------- UMT-L, 2 blocks

def test_umt_l_x_clip_and_grads_match_jax():
    cfg = dict(UMT_L, encoder_depth=2, clip_return_layer=2)
    jm = jumt.PretrainUMT(**cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 224, 224, 3)).astype(np.float32)
    vis, _ = tube_masks(2, 5, UMT_GRID, UMT_MASK)
    assert vis.shape == (2, 320) and not np.array_equal(vis[0], vis[1])
    p = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                                 jnp.asarray(vis[:1]))["params"], 1)
    t = rng.standard_normal((2, 2, 320, 768)).astype(np.float32)

    def jloss(params, v, i):
        out = jm.apply({"params": params}, v, i)
        return jnp.sum((out - t) ** 2), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(vis))
    tm = tumt.PretrainUMT(**cfg)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    assert tm.return_index == (0, 1)
    assert tm.clip_decoder[0].head.weight.shape == (768, 1024)
    tm.train()
    out = tm(torch.from_numpy(x), torch.from_numpy(vis))
    loss = torch.sum((out - torch.from_numpy(t)) ** 2)
    loss.backward()
    assert out.shape == (2, 2, 320, 768)
    assert rel_err(out.detach().numpy(), jout) < 1e-5
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    within_norm({k: v.grad for k, v in tm.named_parameters()},
                flax_to_state_dict(jax.tree.map(np.asarray, jg)), "grads")


# ------------------------------------------------ full depth, on meta

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


def _same_params(model, shapes):
    """Both bridges name every JAX leaf with the port's key and shape; the
    port's parameters are exactly those leaves. Returns their count."""
    state = model.state_dict()
    assert all(v.device.type == "meta" for v in state.values())
    mapped = {}
    for path, arr in _paths(_stand_ins(shapes)):
        key, val = student_key(path, arr, 16)
        jkey, jval = flax_path_to_torch(path, arr, patch_size=16)
        assert (jkey, tuple(jval.shape)) == (key, tuple(val.shape)), path
        mapped[key] = tuple(val.shape)
    params = dict(model.named_parameters())
    assert set(params) == set(mapped), set(params) ^ set(mapped)
    for key, shape in mapped.items():
        assert tuple(state[key].shape) == shape, key
    return sum(int(np.prod(s)) for s in mapped.values())


def test_full_size_videomae_l_builds_as_jax_on_meta():
    name = "pretrain_videomae_large_patch16_224"
    kw = dict(num_frames=16, tubelet_size=2)
    model = create_model(name, device="meta", **kw)
    jm = jmae.__dict__[name](**kw)
    for k, v in dict(VMAE_L, encoder_depth=24, decoder_depth=8).items():
        assert getattr(jm, k) == v, k
    vis, msk = tube_masks(1, 0, MAE_GRID, MAE_MASK)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 16, 224, 224, 3), jnp.float32),
        jnp.asarray(vis), jnp.asarray(msk))["params"]
    n = _same_params(model, shapes)
    assert 3.2e8 < n < 3.5e8  # ~330M: weights, gradients and moments 5.3 GB
    assert len(model.encoder.blocks) == 24 and len(model.decoder.blocks) == 8
    assert model.encoder.blocks[0].attn.num_heads == 16
    assert model.decoder.blocks[0].attn.num_heads == 8
    assert model.encoder_to_decoder.weight.shape == (512, 1024)
    assert model.decoder.head.weight.shape == (1536, 512)


def test_full_size_umt_l_builds_as_jax_on_meta():
    name = "pretrain_umt_large_patch16_224"
    kw = dict(num_frames=8, tubelet_size=1, clip_decoder_embed_dim=1024,
              clip_output_dim=768, clip_return_layer=6)
    model = create_model(name, device="meta", **kw)
    jm = jumt.__dict__[name](**kw)
    for k, v in dict(UMT_L, encoder_depth=24).items():
        assert getattr(jm, k) == v, k
    vis, _ = tube_masks(1, 0, UMT_GRID, UMT_MASK)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 8, 224, 224, 3), jnp.float32),
        jnp.asarray(vis))["params"]
    assert _same_params(model, shapes) > 3e8
    assert model.return_index == jumt.top_down_return_index(24, 6, 1) == (
        18, 19, 20, 21, 22, 23)
    assert len(model.clip_decoder) == 6
    for dec in model.clip_decoder:
        assert dec.head.weight.shape == (768, 1024)
    assert model.clip_pos_embed.shape == (1, 1568, 1024)


# ----------------------------------- the large UMT under its defaults

def test_umt_l_defaults_fail_the_forward_in_both_packages():
    """``clip_decoder_embed_dim`` defaults to 768: a 1024-wide tap plus a
    768-wide positional table. JAX refuses the sum while tracing its init;
    the port while running its forward (1 block suffices)."""
    kw = dict(num_frames=8, tubelet_size=1, clip_return_layer=6)
    jm = jumt.pretrain_umt_large_patch16_224(**kw)
    assert (jm.clip_decoder_embed_dim, jm.clip_output_dim) == (768, 512)
    vis, _ = tube_masks(1, 0, UMT_GRID, UMT_MASK)
    with pytest.raises(TypeError, match=r"1024\).*768\)"):
        jax.eval_shape(
            jm.init, jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct((1, 8, 224, 224, 3), jnp.float32),
            jnp.asarray(vis))
    model = create_model("pretrain_umt_large_patch16_224", device="meta",
                         **kw)
    assert model.clip_pos_embed.shape[-1] == 768
    one = tumt.PretrainUMT(**dict(
        {k: v for k, v in UMT_L.items()
         if k not in ("clip_decoder_embed_dim", "clip_output_dim")},
        encoder_depth=1, clip_return_layer=1))
    assert one.clip_pos_embed.shape[-1] == 768
    x = torch.zeros((1, 8, 224, 224, 3))
    with torch.no_grad(), pytest.raises(RuntimeError, match=r"1024.*768"):
        one.eval()(x, torch.from_numpy(vis))


# ------------------------------------------------------------------ route

def _jax_route(s, fwd_only, dim):
    """JAX's dispatch with its kernels on: the Pallas function a block's
    attention reaches (layers.py -> fused_qkv_attention -> _fused_qkv_fwd),
    or multi_head_attention."""
    if not A.use_fused_qkv(s, True, fwd_only=fwd_only, dim=dim):
        return "multi_head_attention"
    if s > A.FUSED_QKV_FWD_MAX_SEQ and A._packed_flash_ok(s):
        return "packed_flash_fwd"
    return "fused_qkv_fwd"


@pytest.mark.parametrize("fwd_only", [False, True])
@pytest.mark.parametrize("s,dim", [(160, 1024), (320, 1024), (1568, 512),
                                   (160, 512), (320, 512), (1568, 1024)])
def test_route_at_the_large_models_lengths_equals_jax(monkeypatch, s, dim,
                                                      fwd_only):
    """The encoders' 160 and 320 tokens at width 1024 take K1 (and K2 in
    training), the VideoMAE decoder's 1568 at width 512 K3 (and K4), as in
    JAX; the other pairs too."""
    assert TA.use_fused_qkv(s, fwd_only, dim) == A.use_fused_qkv(
        s, True, fwd_only=fwd_only, dim=dim)
    calls = []
    for name in ("fused_qkv_fwd", "fused_qkv_bwd", "packed_flash_fwd",
                 "packed_flash_bwd", "flash_fwd", "grouped_fwd"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    heads = dim // 64
    qkv = torch.randn((1, s, 3 * dim), generator=torch.Generator()
                      .manual_seed(s + dim)).requires_grad_(not fwd_only)
    out = TA.self_attention(qkv, heads, 64 ** -0.5, dim=dim,
                            fwd_only=fwd_only)
    assert out.shape == (1, s, dim)
    want = [_jax_route(s, fwd_only, dim)]
    assert want[0] != "multi_head_attention"
    if not fwd_only:
        out.sum().backward()
        want.append(want[0].replace("_fwd", "_bwd"))
    assert calls == want
