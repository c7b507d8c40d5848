"""unite_torch stage-1 step and its step-side ops against unite_tpu, on the CPU.

The gate: one fp32 step of ``make_pretrain_train_step`` with equal params,
batch and injected ``vis_idx`` (drop path 0, AdamW with lr/wd tables)
matches the JAX step's loss, grad norm and every updated parameter, and so
does a second step (Adam's bias correction, the table index). Random draws
differ between the packages, so the mask test feeds both the same Gumbel
noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.engines import losses as jlosses
from unite_tpu.engines.pretrain_umt import (
    make_pretrain_train_step as jax_step_builder,
)
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.ops import eval_transforms as jet
from unite_tpu.ops import masking as jmask
from unite_tpu.ops import normalize as jnorm
from unite_tpu.optim import factory as jfactory
from unite_tpu.train.run_stage1 import unused_block_mask
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_torch.engines import losses as tlosses
from unite_torch.engines.pretrain_umt import make_pretrain_train_step
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.ops import eval_transforms as tet
from unite_torch.ops import masking as tmask
from unite_torch.ops import normalize as tnorm
from unite_torch.optim import factory as tfactory
from unite_torch.train.train_state import TrainState
from unite_torch.utils import schedules as tsched
from unite_torch.utils.flax_bridge import flatten, flax_to_state_dict

STUDENT = dict(img_size=32, patch_size=16, encoder_embed_dim=128,
               encoder_depth=3, encoder_num_heads=2, num_frames=4,
               tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
               clip_return_layers=(0, 1))  # block 2 never runs: frozen
TEACHER = dict(input_resolution=32, patch_size=16, width=128, layers=3,
               heads=2, output_dim=64, return_attn=True, return_index=(0, 1))
GEOM = dict(num_patches=16, frames=4, mask_ratio=0.5)


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def batch_np(b=2, seed=0):
    rng = np.random.default_rng(seed)
    vids = rng.integers(0, 256, (b, 4, 32, 32, 3), dtype=np.uint8)
    idx = np.stack([np.sort(np.concatenate(
        [f * 4 + rng.choice(4, 2, replace=False) for f in range(4)]))
        for _ in range(b)]).astype(np.int32)
    return vids, idx


# --------------------------------------------------------------- step ops


def test_normalize_videos():
    vids, _ = batch_np()
    for x in (vids, vids.astype(np.float32) / 50.0):
        ref = f32(jnorm.normalize_videos(jnp.asarray(x)))
        out = tnorm.normalize_videos(torch.from_numpy(x))
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(), ref)
    out = tnorm.normalize_videos(torch.from_numpy(vids), torch.float32)
    ref = f32(jnorm.normalize_videos(jnp.asarray(vids), jnp.float32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [(224, 196), (32, 48), (37, 16)])
def test_bicubic_resize(src, dst):
    np.testing.assert_array_equal(tet.torch_bicubic_weights(src, dst),
                                  jet.torch_bicubic_weights(src, dst))
    x = np.random.default_rng(src).standard_normal(
        (2, 3, src, src, 3)).astype(np.float32)
    out = tet.bicubic_resize_square(torch.from_numpy(x), dst)
    ref = f32(jet.bicubic_resize_square(jnp.asarray(x), dst))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # and torch's own bicubic interpolation (a = -0.75, no antialias), up
    # to fp32 summation order on N(0, 1) frames
    it = torch.nn.functional.interpolate(
        torch.from_numpy(x).flatten(0, 1).permute(0, 3, 1, 2), size=(dst, dst),
        mode="bicubic", align_corners=False)
    np.testing.assert_allclose(
        out.flatten(0, 1).permute(0, 3, 1, 2).numpy(), it.numpy(),
        rtol=1e-4, atol=3e-4)


def test_visible_indices_is_stable():
    rng = np.random.default_rng(1)
    mask = rng.random((5, 196)) < 0.8
    mask[:, :40] = False
    n = 40
    mask = np.stack([np.isin(np.arange(196), rng.choice(196, 196 - n, False))
                     for _ in range(5)])
    out = tmask.visible_indices(torch.from_numpy(mask), n)
    ref = np.asarray(jmask.visible_indices(jnp.asarray(mask), n))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert all(np.all(np.diff(r) > 0) for r in out.numpy())


def test_attention_mask_with_the_same_gumbel_noise():
    rng = np.random.default_rng(2)
    attn = rng.dirichlet(np.ones(196), size=16).astype(np.float32)
    attn[0, :5] = 0.0  # log(max(w, 1e-30)) keeps zeros finite
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jmask.attention_multinomial_mask(key, jnp.asarray(attn),
                                                      0.8))
    g = np.array(jax.random.gumbel(key, attn.shape, dtype=jnp.float32))
    out = tmask.attention_multinomial_mask(torch.from_numpy(attn), 0.8,
                                           gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (~out).sum(-1).tolist() == [tmask.n_visible(196, 0.8)] * 16
    video = tmask.frame_mask_to_video(out, 2)
    np.testing.assert_array_equal(
        video.numpy(), np.asarray(jmask.frame_mask_to_video(ref, 2)))
    assert tmask.n_visible_total(1568, 8, 0.8) == 320
    assert tmask.n_visible_total(1568, 8, 0.8, "random") == 314


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loss_type", ["l2", "mse", "l1", "smooth_l1"])
def test_clip_alignment_loss(loss_type, weighted):
    rng = np.random.default_rng(3)
    x, t = (rng.standard_normal((2, 4, 5, 8)).astype(np.float32) * 1.5
            for _ in range(2))
    w = np.array([1, 0, 1, 0], np.float32) if weighted else None
    ref = float(jlosses.clip_alignment_loss(
        jnp.asarray(x), jnp.asarray(t), loss_type,
        None if w is None else jnp.asarray(w)))
    out = tlosses.clip_alignment_loss(
        torch.from_numpy(x), torch.from_numpy(t), loss_type,
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(out.item(), ref, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_epochs=1,
                                             start_warmup_value=1e-6),
                                dict(warmup_steps=3)])
def test_cosine_scheduler(kw):
    np.testing.assert_array_equal(
        tsched.cosine_scheduler(1.5e-4, 1e-5, 3, 7, **kw),
        jsched.cosine_scheduler(1.5e-4, 1e-5, 3, 7, **kw))
    assert tsched.scaled_lr(1.5e-4, 64) == jsched.scaled_lr(1.5e-4, 64)


def _jax_models():
    sj = jad.AdaptationVisionTransformer(**STUDENT)
    tj = jclip.CLIPVisionTransformer(**TEACHER)
    vids, idx = batch_np()
    x = jnp.asarray(vids[:1], jnp.float32)
    sp = perturb(sj.init(jax.random.PRNGKey(0), x, jnp.asarray(idx[:1]),
                         False)["params"], 1)
    tp = perturb(tj.init(jax.random.PRNGKey(1), x)["params"], 2)
    return sj, tj, sp, tp


def test_decay_split_by_name_matches_jax():
    _, _, sp, _ = _jax_models()
    sm = tad.AdaptationVisionTransformer(**STUDENT)
    frozen = ("encoder.blocks.2.",)
    groups = tfactory.param_group_metadata(
        sm.named_parameters(), 0.05,
        trainable=lambda n: not n.startswith(frozen))
    _, _, jgroups = jfactory.param_group_metadata(
        sp, 0.05, trainable_mask=unused_block_mask(sp, 1))
    assert set(groups) == set(jgroups) == {"decay", "no_decay", "frozen"}
    state_names = {".".join(k): n for k, n in zip(
        flatten(sp), flax_to_state_dict(sp))}
    for name, g in groups.items():
        assert sorted(g["params"]) == sorted(
            state_names[p] for p in jgroups[name]["params"])
        assert g["lr_scale"] == jgroups[name]["lr_scale"]
        assert g["weight_decay"] == jgroups[name]["weight_decay"]


# ------------------------------------------------------------------ gate


@pytest.mark.parametrize("loss_data,clip_grad", [("target", None),
                                                 ("mixed", 0.05)])
def test_step_gate_matches_jax_over_two_steps(loss_data, clip_grad):
    sj, tj, sp, tp = _jax_models()
    lr_tab = jsched.cosine_scheduler(5e-4, 2.5e-5, 1, 3, warmup_steps=1,
                                     start_warmup_value=2.5e-4)
    wd_tab = jsched.cosine_scheduler(0.05, 0.2, 1, 3)
    # eps 1e-6 (the stage-1 config has 1e-8): Adam's g/(|g| + eps) turns
    # fp32 summation noise in near-zero gradients into O(1) differences of
    # the update at a smaller eps; the arithmetic under test is the same
    eps = 1e-6
    geom = dict(GEOM, source_batch_size=1, clip_loss_data=loss_data,
                clip_grad=clip_grad, clip_input_resolution=32)
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr_tab, params=sp, weight_decay=wd_tab,
        betas=(0.9, 0.95), eps=eps, trainable_mask=unused_block_mask(sp, 1))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, sp), tx)
    jstep = jax.jit(jax_step_builder(sj, tj, **geom))

    sm = tad.AdaptationVisionTransformer(**STUDENT)
    sm.load_state_dict(flax_to_state_dict(sp))
    tm = tclip.CLIPVisionTransformer(**TEACHER)
    tm.load_state_dict(flax_to_state_dict(tp, kind="clip"))
    opt, _ = tfactory.create_optimizer("adamw", lr_tab, sm,
                                       weight_decay=wd_tab, betas=(0.9, 0.95),
                                       eps=eps, device="cpu")
    state = TrainState(sm, opt)
    step = make_pretrain_train_step(sm, tm, device="cpu", **geom)

    frozen_before = sm.encoder.blocks[2].attn.qkv.weight.detach().clone()
    prev = {k: v.clone() for k, v in sm.state_dict().items()}
    for i in range(2):
        vids, idx = batch_np(seed=10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, tp),
                           {"videos": jnp.asarray(vids),
                            "vis_idx": jnp.asarray(idx)},
                           jax.random.PRNGKey(0))
        m = step(state, {"videos": torch.from_numpy(vids),
                         "vis_idx": torch.from_numpy(idx)})
        for k in ("loss", "loss_clip", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5)
        ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
        got = sm.state_dict()
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            # the update itself, not only the weights it lands on (as a
            # norm: single near-zero gradients differ in sign by summation
            # order, which Adam turns into elementwise update differences)
            d_got, d_ref = got[k] - prev[k], ref[k] - prev[k]
            if k.startswith("encoder.blocks.2."):
                assert d_ref.abs().max() == 0 and d_got.abs().max() == 0
            else:
                assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm(), k
        prev = {k: v.clone() for k, v in got.items()}
    assert state.step == 2 and opt.count == 2
    assert sm.encoder.blocks[2].attn.qkv.weight.grad is None
    torch.testing.assert_close(sm.encoder.blocks[2].attn.qkv.weight,
                               frozen_before, rtol=0, atol=0)


def test_bf16_student_forward_near_jax():
    sj = jad.AdaptationVisionTransformer(**STUDENT, dtype=jnp.bfloat16)
    _, _, sp, _ = _jax_models()
    sm = tad.AdaptationVisionTransformer(**STUDENT, dtype=torch.bfloat16)
    sm.load_state_dict(flax_to_state_dict(sp))
    vids, idx = batch_np(seed=4)
    xj = jnorm.normalize_videos(jnp.asarray(vids))
    ref = f32(sj.apply({"params": sp}, xj, jnp.asarray(idx), True))
    with torch.no_grad():
        out = sm.eval()(tnorm.normalize_videos(torch.from_numpy(vids)),
                        torch.from_numpy(idx).long(), clip_only=True)
    assert out.dtype == torch.bfloat16
    # L2-normed 64-d rows; bf16 rounds at other points in the two packages
    # (the port follows the kernel's p rounding, JAX on the CPU its XLA path)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=3e-2)


def test_step_checks_the_teacher_grid():
    sm = tad.AdaptationVisionTransformer(**STUDENT)
    tm = tclip.CLIPVisionTransformer(**dict(TEACHER, input_resolution=48))
    opt, _ = tfactory.create_optimizer("adamw", 1e-3, sm, device="cpu")
    step = make_pretrain_train_step(sm, tm, source_batch_size=0,
                                    clip_input_resolution=48, device="cpu",
                                    **GEOM)
    vids, _ = batch_np()
    with pytest.raises(ValueError, match="teacher patch grid"):
        step(TrainState(sm, opt), {"videos": torch.from_numpy(vids)})
