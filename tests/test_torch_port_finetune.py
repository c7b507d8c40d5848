"""unite_torch stage-2 finetune slice against unite_tpu, fp32 on the CPU.

A ViT of depth 2, width 128 and 2 heads over 4 frames of 224^2 with tubelet
1: 784 tokens, so the port's attention takes the packed route (the plain K3
and K4 on the CPU; JAX on the CPU runs its XLA reference, which in fp32 is
the same function). Weights come from the flax ``init`` plus seeded noise
and cross over through ``unite_torch.utils.flax_bridge``; drop path is 0.

The gate: two ``make_finetune_train_step`` steps with layer decay 0.65 and
block 0 frozen match the JAX step's loss, grad norm, accuracy and every
updated parameter, and block 0 does not move.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_torch
from unite_tpu.engines import finetune as jft
from unite_tpu.engines import losses as jlosses
from unite_tpu.models import vit as jvit
from unite_tpu.optim import factory as jfactory
from unite_tpu.train import run_stage2 as jrun2
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_tpu.utils.torch_export import flax_params_to_state
from unite_torch.engines import finetune as tft
from unite_torch.engines import losses as tlosses
from unite_torch.models import vit as tvit
from unite_torch.optim import factory as tfactory
from unite_torch.train import run_stage2 as trun2
from unite_torch.train.train_state import TrainState
from unite_torch.utils.flax_bridge import flatten, flax_to_state_dict

CFG = dict(img_size=224, patch_size=16, num_classes=12, embed_dim=128,
           depth=2, num_heads=2, all_frames=4, tubelet_size=1,
           init_scale=0.001)
STAGE2 = SimpleNamespace(frozen_layers="0", train_head_only=False,
                         freeze_patch_embedding=False)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def batch_np(b=2, seed=0, classes=12):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 4, 224, 224, 3), dtype=np.uint8),
            rng.integers(0, classes, (b,)).astype(np.int32))


@pytest.fixture(scope="module")
def vit_pair():
    jm = jvit.VisionTransformer(**CFG)
    vids, _ = batch_np(1)
    p = perturb(jm.init(jax.random.PRNGKey(0),
                        jnp.asarray(vids, jnp.float32))["params"], 1)
    return jm, p


def port_vit(p, **kw):
    tm = tvit.VisionTransformer(**dict(CFG, **kw))
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    return tm


def close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(a).detach().float()),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol)


def test_forward_logits_match_jax(vit_pair):
    jm, p = vit_pair
    vids, _ = batch_np(seed=3)
    x = np.asarray(vids, np.float32) / 64.0 - 2.0
    ref = jm.apply({"params": p}, jnp.asarray(x), True)
    with torch.no_grad():
        out = port_vit(p).eval()(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 12)
    close(out, ref)


@pytest.mark.parametrize("kw", [dict(use_mean_pooling=False),
                                dict(classifier_type="mlp",
                                     classifier_hidden_dim=32),
                                dict(use_learnable_pos_emb=True)])
def test_readout_variants_match_jax(kw):
    cfg = dict(CFG, depth=1, all_frames=2, **kw)
    jm = jvit.VisionTransformer(**cfg)
    x = np.random.default_rng(4).standard_normal(
        (2, 2, 224, 224, 3)).astype(np.float32)
    p = perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 5)
    tm = tvit.VisionTransformer(**cfg)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    with torch.no_grad():
        close(tm.eval()(torch.from_numpy(x)),
              jm.apply({"params": p}, jnp.asarray(x), True))


def test_dropout_is_refused():
    with pytest.raises(NotImplementedError, match="item 4"):
        tvit.VisionTransformer(**dict(CFG, drop_rate=0.1))


@pytest.mark.parametrize("name,frames,tubelet,kw", [
    ("vit_base_patch16_224", 8, 1, {}),
    ("vit_base_patch16_224", 16, 2, {}),
    ("vit_base_patch16_224", 8, 1, dict(use_mean_pooling=False,
                                        classifier_type="mlp")),
])
def test_bridge_loads_a_full_vit_strictly(name, frames, tubelet, kw):
    # shapes from jax.eval_shape (no full-size forward on the CPU), values
    # from numpy; both exporters give the same keys and tensors
    from unite_tpu import create_model as jcreate

    kw = dict(num_classes=12, all_frames=frames, tubelet_size=tubelet, **kw)
    jm = jcreate(name, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(
        (1, frames, 224, 224, 3)))["params"]
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    state = flax_to_state_dict(p)
    tm = unite_torch.create_model(name, device="cpu", **kw)
    tm.load_state_dict(state, strict=True)
    assert tm.patch_embed.proj.weight.shape[2] == tubelet
    theirs = flax_params_to_state(p)
    assert set(state) == set(theirs)
    for k in ("blocks.0.attn.q_bias", "blocks.0.attn.v_bias",
              "patch_embed.proj.weight"):
        torch.testing.assert_close(state[k], theirs[k], rtol=0, atol=0)


def _groups_by_torch_name(p, jgroups):
    names = {".".join(k): n for k, n in zip(flatten(p), flax_to_state_dict(p))}
    return {g: sorted(names[x] for x in v["params"])
            for g, v in jgroups.items()}


def test_layer_decay_groups_match_jax(vit_pair):
    _, p = vit_pair
    tm = port_vit(p)
    mask = trun2.trainable_mask(STAGE2, tm)
    groups = tfactory.param_group_metadata(
        tm.named_parameters(), 0.05, trainable=mask.__getitem__,
        num_layers=2, layer_decay=0.65)
    _, _, jgroups = jfactory.param_group_metadata(
        p, 0.05, num_layers=2, layer_decay=0.65,
        trainable_mask=jrun2.trainable_mask(STAGE2, p))
    assert set(groups) == set(jgroups) == {
        "frozen", "layer_0_decay", "layer_0_no_decay", "layer_2_decay",
        "layer_2_no_decay", "layer_3_decay", "layer_3_no_decay"}
    names = _groups_by_torch_name(p, jgroups)
    for g, meta in groups.items():
        assert sorted(meta["params"]) == names[g], g
        assert meta["lr_scale"] == jgroups[g]["lr_scale"], g
        assert meta["weight_decay"] == jgroups[g]["weight_decay"], g
    assert tfactory.layer_decay_scales(0.65, 12) == \
        jfactory.layer_decay_scales(0.65, 12)
    for path, name in (
            (("encoder", "blocks_4", "mlp"), "encoder.blocks.4.mlp"),
            (("pos_embed",), "pos_embed"), (("head", "kernel"), "head.weight"),
            (("patch_embed", "proj"), "patch_embed.proj.weight"),
            (("class_embedding",), "class_embedding"),
            (("resblocks_3", "ln_1"), "transformer.resblocks.3.ln_1.weight")):
        assert tfactory.get_num_layer_for_vit(name, 14) == \
            jfactory.get_num_layer_for_vit(path, 14), path


def test_trainable_mask_and_build_model_follow_the_args(vit_pair):
    _, p = vit_pair
    tm = port_vit(p)
    jmask = {".".join(k): v for k, v in
             flatten(jrun2.trainable_mask(STAGE2, p)).items()}
    names = {".".join(k): n for k, n in zip(flatten(p), flax_to_state_dict(p))}
    want = {names[k]: bool(v) for k, v in jmask.items()}
    for lp in (False, True):
        got = trun2.trainable_mask(STAGE2, tm, lp_phase=lp)
        if not lp:
            assert got == want
        else:
            assert not any(v for k, v in got.items()
                           if k.startswith(("blocks.", "patch_embed.")))
    args = SimpleNamespace(
        model="vit_base_patch16_224", nb_classes=12, num_frames=8,
        tubelet_size=1, fc_drop_rate=0.0, drop=0.0, attn_drop_rate=0.0,
        drop_path=0.1, use_learnable_pos_emb=False, use_mean_pooling=True,
        init_scale=0.001, head_type="linear", head_hidden_dim=256)
    m = trun2.build_model(args, device="cpu")
    assert m.dtype == torch.bfloat16 and m.depth == 12
    assert m.pos_embed.shape == (1, 1568, 768)
    assert m.head.weight.abs().max() < 0.001 * 0.05
    assert [b.drop_path.rate for b in m.blocks][-1] == pytest.approx(0.1)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy(smoothing, reduction):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((5, 12)).astype(np.float32) * 3
    labels = rng.integers(0, 12, 5).astype(np.int32)
    ref = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                smoothing, reduction)
    out = tlosses.cross_entropy(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels), smoothing,
                                reduction)
    ref_bf = jlosses.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                   jnp.asarray(labels), smoothing, reduction)
    assert out.dtype == torch.float32
    close(out, ref_bf, rtol=1e-6, atol=1e-6)
    close(tlosses.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), smoothing,
                                reduction), ref, rtol=1e-6, atol=1e-6)


def test_soft_target_cross_entropy_and_topk():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((6, 12)).astype(np.float32)
    t = rng.dirichlet(np.ones(12), size=6).astype(np.float32)
    close(tlosses.soft_target_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(t)),
          jlosses.soft_target_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(t)), rtol=1e-6)
    for classes in (12, 3):  # k clamped to the class count
        lg = logits[:, :classes]
        labels = rng.integers(0, classes, 6).astype(np.int32)
        got = tlosses.accuracy_topk(torch.from_numpy(lg),
                                    torch.from_numpy(labels))
        ref = jlosses.accuracy_topk(jnp.asarray(lg), jnp.asarray(labels))
        assert [g.item() for g in got] == pytest.approx(
            [float(r) for r in ref])


def test_merge_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    for rank in range(2):
        recs = []
        for v in range(5):
            for view in range(3):  # view 0 repeats across ranks (padding)
                recs.append((f"vid{v}", rng.dirichlet(np.ones(12)), v % 12,
                             view if rank == 0 else max(view - 1, 0), 0))
        tft.write_preds_file(str(tmp_path / f"{rank}.txt"), recs)
        jft.write_preds_file(str(tmp_path / f"j{rank}.txt"), recs)
        assert (tmp_path / f"{rank}.txt").read_text() == \
            (tmp_path / f"j{rank}.txt").read_text()
    assert tft.merge(str(tmp_path), 2) == jft.merge(str(tmp_path), 2)
    assert tft.merge(str(tmp_path / "none"), 2) == (0.0, 0.0)


def _jax_state_and_step(jm, p, lr_tab, wd_tab, eps, ema_decay):
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr_tab, params=p, weight_decay=wd_tab,
        betas=(0.9, 0.999), eps=eps, num_layers=2, layer_decay=0.65,
        trainable_mask=jrun2.trainable_mask(STAGE2, p))
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, p), tx,
                                 ema_decay=ema_decay)
    step = jax.jit(jft.make_finetune_train_step(jm, ema_decay=ema_decay))
    return state, step


def _port_state_and_step(p, lr_tab, wd_tab, eps, ema_decay):
    tm = port_vit(p)
    mask = trun2.trainable_mask(STAGE2, tm)
    opt, _ = tfactory.create_optimizer(
        "adamw", lr_tab, tm, weight_decay=wd_tab, betas=(0.9, 0.999),
        eps=eps, trainable=mask.__getitem__, num_layers=tm.depth,
        layer_decay=0.65, device="cpu")
    state = TrainState(tm, opt, ema_decay=ema_decay)
    return state, tft.make_finetune_train_step(tm, ema_decay=ema_decay,
                                                device="cpu")


@pytest.mark.parametrize("ema_decay", [None, 0.9])
def test_step_gate_matches_jax_over_two_steps(vit_pair, ema_decay):
    jm, p = vit_pair
    lr_tab = jsched.cosine_scheduler(5e-4, 1e-5, 1, 3)
    wd_tab = jsched.cosine_scheduler(0.05, 0.05, 1, 3)
    # eps 1e-6 (the stage-2 config has 1e-8): Adam's g/(|g| + eps) turns
    # fp32 summation noise in near-zero gradients into O(1) differences of
    # the update at a smaller eps; the arithmetic under test is the same
    eps = 1e-6
    jstate, jstep = _jax_state_and_step(jm, p, lr_tab, wd_tab, eps, ema_decay)
    state, step = _port_state_and_step(p, lr_tab, wd_tab, eps, ema_decay)
    tm = state.model
    assert all(q.requires_grad for q in tm.parameters())
    frozen_before = {k: v.clone() for k, v in tm.state_dict().items()
                     if k.startswith("blocks.0.")}
    prev = {k: v.clone() for k, v in tm.state_dict().items()}
    for i in range(2):
        vids, labels = batch_np(seed=10 + i)
        jstate, jm_ = jstep(jstate, {"videos": jnp.asarray(vids),
                                     "labels": jnp.asarray(labels)},
                            jax.random.PRNGKey(0))
        m = step(state, {"videos": torch.from_numpy(vids),
                         "labels": torch.from_numpy(labels)})
        for k in ("loss", "grad_norm", "class_acc", "acc5"):
            np.testing.assert_allclose(m[k].item(), float(jm_[k]), rtol=1e-5,
                                       err_msg=k)
        # the frozen block has its gradient, and it counts in the norm
        assert tm.blocks[0].attn.qkv.weight.grad.abs().max() > 0
        ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
        got = tm.state_dict()
        assert set(ref) == set(got)
        for k in ref:
            close(got[k], ref[k], rtol=1e-5, atol=1e-6)
            d_got, d_ref = got[k] - prev[k], ref[k] - prev[k]
            if k.startswith("blocks.0."):
                assert d_ref.abs().max() == 0 and d_got.abs().max() == 0
            else:
                assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm(), k
        prev = {k: v.clone() for k, v in got.items()}
        if ema_decay is not None:
            jema = flax_to_state_dict(jax.tree.map(np.asarray,
                                                   jstate.ema_params))
            assert set(jema) == set(state.ema_params)
            for k, v in jema.items():
                close(state.ema_params[k], v, rtol=1e-5, atol=1e-6)
    assert state.step == 2 and state.optimizer.count == 2
    for k, v in frozen_before.items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("use_ema", [False, True])
def test_eval_step_matches_jax(vit_pair, use_ema):
    jm, p = vit_pair
    ema = perturb(p, 9)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, p),
                                  jfactory.create_optimizer(
                                      "adamw", 1e-3, p)[0], ema_decay=0.9)
    jstate = jstate.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    vids, labels = batch_np(b=3, seed=12)
    batch = {"videos": jnp.asarray(vids), "labels": jnp.asarray(labels)}
    ref = jax.jit(jft.make_eval_step(jm, use_ema=use_ema))(jstate, batch)
    tm = port_vit(p)
    opt, _ = tfactory.create_optimizer("adamw", 1e-3, tm, device="cpu")
    state = TrainState(tm, opt, ema_decay=0.9)
    state.ema_params = {k: v for k, v in flax_to_state_dict(ema).items()}
    out = tft.make_eval_step(tm, use_ema=use_ema, device="cpu")(
        state, {"videos": torch.from_numpy(vids),
                "labels": torch.from_numpy(labels)})
    close(out["probs"], ref["probs"], rtol=1e-5, atol=1e-6)
    for k in ("acc1", "acc5", "loss"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert torch.equal(out["labels"], torch.from_numpy(labels))


def test_mixup_waits_for_its_port():
    tm = tvit.VisionTransformer(**dict(CFG, depth=1))
    with pytest.raises(NotImplementedError, match="mixup"):
        tft.make_finetune_train_step(tm, mixup=object(), device="cpu")
