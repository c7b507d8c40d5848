"""unite_torch stage-3 self-training slice against unite_tpu, fp32 on the CPU.

A student of depth 2, width 128 and 2 heads over 4 frames of 32^2 with
tubelet 1 (16 patches, 17 tokens with CLS), a CLIP teacher of the same
geometry with the attention row, and a 12-class linear classifier. Weights
come from the flax ``init`` plus seeded noise and cross over through
``unite_torch.utils.flax_bridge``; the batch comes from numpy seeds; drop
path is 0.

The gate: two ``make_selftrain_step`` steps, without and with the CLS token,
match the JAX step's loss and grad norm within 1e-5 relative, every
diagnostic and per-sample prediction exactly (the selection is a function
of them), and every updated parameter within 1e-5: the CLIP decoders decay
(they get a zero gradient, as in JAX) and the frozen classifier does not
move. Adam's eps is 1e-6 in the gate (the config has 1e-8): g/(|g| + eps)
turns fp32 summation noise in near-zero gradients into O(1) differences of
the update at a smaller eps; the arithmetic under test is the same.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.engines import selftrain as jst
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.ops import masking as jmask
from unite_tpu.optim import factory as jfactory
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_torch.engines import selftrain as tst
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.ops import masking as tmask
from unite_torch.train import run_stage3 as trun3
from unite_torch.train.train_state import TrainState
from unite_torch.utils.flax_bridge import flatten, flax_to_state_dict

STUDENT = dict(img_size=32, patch_size=16, encoder_embed_dim=128,
               encoder_depth=2, encoder_num_heads=2, num_frames=4,
               tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
               clip_return_layers=(1,))
TEACHER = dict(input_resolution=32, patch_size=16, width=128, layers=2,
               heads=2, output_dim=64, return_attn=True, return_index=(1,))
GEOM = dict(num_patches=16, frames=4, mask_ratio=0.5, nb_classes=12,
            clip_input_resolution=32)
ARGS = SimpleNamespace(opt="adamw", opt_betas=[0.9, 0.95], opt_eps=1e-6,
                       nb_classes=12, freeze_clip_decoders=False,
                       src_classifier_type="linear")
B_S, B_T = 2, 4


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def batch_np(seed, clip_sim=None):
    rng = np.random.default_rng(seed)
    vids = lambda b: rng.integers(0, 256, (b, 4, 32, 32, 3), dtype=np.uint8)
    batch = {"videos_s": vids(B_S), "labels_s": rng.integers(0, 12, B_S),
             "videos_t": vids(B_T), "videos_t_aug": vids(B_T),
             "labels_t": rng.integers(0, 12, B_T),
             "classwise_thresholds": rng.uniform(0.0, 0.3, 12).astype(
                 np.float32)}
    logits = rng.standard_normal((B_T, 12)) * np.array([[3.0], [0.1], [3.0],
                                                        [0.1]])
    sim = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    batch["clip_sim"] = (sim if clip_sim is None else clip_sim).astype(
        np.float32)
    for k in ("labels_s", "labels_t"):
        batch[k] = batch[k].astype(np.int32)
    return batch


class Pair:
    """The JAX models and params, and the port's modules loaded from them."""

    def __init__(self, use_cls_token: bool, **student_kw):
        cfg = dict(STUDENT, use_cls_token=use_cls_token, **student_kw)
        self.sj = jad.AdaptationVisionTransformer(**cfg)
        self.tj = jclip.CLIPVisionTransformer(**TEACHER)
        self.cj = fnn.Dense(12, param_dtype=jnp.float32, dtype=jnp.float32)
        x = jnp.zeros((1, 4, 32, 32, 3))
        self.sp = perturb(self.sj.init(jax.random.PRNGKey(0), x)["params"], 1)
        self.tp = perturb(self.tj.init(jax.random.PRNGKey(1), x)["params"], 2)
        self.hp = perturb(self.cj.init(jax.random.PRNGKey(2),
                                       jnp.zeros((1, 128)))["params"], 3)
        self.sm = tad.AdaptationVisionTransformer(**cfg)
        self.sm.load_state_dict(flax_to_state_dict(self.sp), strict=True)
        self.tm = tclip.CLIPVisionTransformer(**TEACHER)
        self.tm.load_state_dict(flax_to_state_dict(self.tp, kind="clip"),
                                strict=True)
        self.cm = trun3.build_classifier(ARGS, 128, device="cpu")
        self.cm.load_state_dict({
            "weight": torch.from_numpy(self.hp["kernel"].T.copy()),
            "bias": torch.from_numpy(self.hp["bias"].copy())})
        self.model = trun3.combine(self.sm, self.cm)

    def jax_state(self, lr, wd, eps=1e-6):
        params = {"model": self.sp, "classifier": self.hp}
        tmask = {"model": jax.tree.map(lambda _: True, self.sp),
                 "classifier": jax.tree.map(lambda _: False, self.hp)}
        tx, _ = jfactory.create_optimizer(
            "adamw", lr=lr, params=params, weight_decay=wd,
            betas=(0.9, 0.95), eps=eps, trainable_mask=tmask)
        return JaxTrainState.create(jax.tree.map(jnp.asarray, params), tx)

    def port_state(self, lr, wd, args=ARGS):
        tx, _ = trun3.build_optimizer(args, self.model, lr, wd, device="cpu")
        return TrainState(self.model, tx)

    def steps(self, **kw):
        jstep = jax.jit(jst.make_selftrain_step(self.sj, self.cj, self.tj,
                                                **GEOM, **kw))
        step = tst.make_selftrain_step(self.sm, self.cm, self.tm, device="cpu",
                                       **GEOM, **kw)
        return jstep, step

    def port_params(self):
        return {k: v.clone() for k, v in self.model.state_dict().items()}


def jax_params(jstate):
    p = jax.tree.map(np.array, jstate.params)
    out = {f"model.{k}": v for k, v in flax_to_state_dict(p["model"]).items()}
    out["classifier.weight"] = torch.from_numpy(p["classifier"]["kernel"].T)
    out["classifier.bias"] = torch.from_numpy(p["classifier"]["bias"])
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_metrics(m, jm):
    assert set(jm) == set(m), set(jm) ^ set(m)
    for k in jm:
        if k in ("loss", "grad_norm", "loss_class", "loss_class_t"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        else:  # selection diagnostics and per-sample predictions
            np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]),
                                          err_msg=k)


LR = jsched.cosine_scheduler(5e-4, 2.5e-5, 1, 3, warmup_steps=1,
                             start_warmup_value=2.5e-4)
WD = jsched.cosine_scheduler(0.05, 0.2, 1, 3)


@pytest.mark.parametrize("use_cls_token", [False, True])
def test_stage3_gate_matches_jax_over_two_steps(use_cls_token):
    pair = Pair(use_cls_token)
    jstate = pair.jax_state(LR, WD)
    state = pair.port_state(LR, WD)
    jstep, step = pair.steps()
    init = pair.port_params()
    prev = init
    for i in range(2):
        batch = batch_np(10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, pair.tp),
                           to_jax(batch), jax.random.PRNGKey(0))
        m = step(state, to_torch(batch))
        check_metrics(m, jm)
        ref, got = jax_params(jstate), pair.model.state_dict()
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            d_got, d_ref = got[k] - prev[k], ref[k] - prev[k]
            assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm() + 1e-9, k
        prev = {k: v.clone() for k, v in got.items()}
    assert 0.0 < float(jm["sel_ratio"]) < 1.0  # the selection is not trivial
    final = pair.model.state_dict()
    for k in ("classifier.weight", "classifier.bias"):
        torch.testing.assert_close(final[k], init[k], rtol=0, atol=0)
    # the decoder gets no gradient from the loss and still decays
    dec = "model.clip_decoder.0.head.weight"
    assert (final[dec] - init[dec]).abs().max() > 0
    assert pair.sm.clip_decoder[0].head.weight.grad.abs().max() == 0
    assert state.step == 2 and state.optimizer.count == 2


STRATEGIES = [
    ("conf", {}), ("cons", {}), ("consORconf", {}), ("consANDconf", {}),
    ("classwise-conf", {}), ("consORclasswise-conf", {}),
    ("consANDclasswise-conf", {}), ("clip_only", dict(global_threshold=0.2)),
    ("clip_matchORconf", dict(conf_weighted_loss=False,
                              class_loss_tgt_ratio=0.5)),
    ("oracle", {}), ("consORconf", dict(train_masked=False)),
    ("clip_matchORconf", dict(full_oracle=True, committee_size=1)),
    ("cons", dict(committee_size=1, class_loss_src_ratio_pl=0.3)),
]


@pytest.mark.parametrize("strategy,kw", STRATEGIES)
def test_every_selection_strategy_matches_jax(strategy, kw):
    pair = Pair(use_cls_token=False)
    jstate = pair.jax_state(1e-4, 0.05)
    state = pair.port_state(1e-4, 0.05)
    jstep, step = pair.steps(selection_strategy=strategy, **kw)
    batch = batch_np(20)
    batch["attn"] = np.random.default_rng(21).dirichlet(
        np.ones(4), size=B_T * 4).astype(np.float32)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, pair.tp),
                       to_jax(batch), jax.random.PRNGKey(0))
    check_metrics(step(state, to_torch(batch)), jm)
    ref, got = jax_params(jstate), pair.model.state_dict()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_merged_full_passes_match_jax_and_the_split_passes():
    pair = Pair(use_cls_token=True)
    jstate = pair.jax_state(1e-4, 0.05)
    state = pair.port_state(1e-4, 0.05)
    jstep, step = pair.steps(merge_full_passes=True)
    batch = batch_np(30)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, pair.tp),
                       to_jax(batch), jax.random.PRNGKey(0))
    m = step(state, to_torch(batch))
    check_metrics(m, jm)
    split = Pair(use_cls_token=True)
    m_split = split.steps()[1](split.port_state(1e-4, 0.05),
                               to_torch(batch))
    for k in m:
        torch.testing.assert_close(m[k], m_split[k], rtol=1e-5, atol=1e-6)
    for k, v in pair.model.state_dict().items():
        torch.testing.assert_close(v, split.model.state_dict()[k], rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="merge_full_passes requires"):
        Pair(use_cls_token=False, drop_path_rate=0.1).steps(
            merge_full_passes=True)


def test_step_checks_the_committee_and_its_inputs():
    pair = Pair(use_cls_token=False)
    with pytest.raises(ValueError, match="committee of k=2"):
        tst.make_selftrain_step(pair.sm, pair.cm, pair.tm, device="cpu",
                                **dict(GEOM, mask_ratio=0.25))
    with pytest.raises(ValueError, match="committee of k=2"):
        jst.make_selftrain_step(pair.sj, pair.cj, pair.tj,
                                **dict(GEOM, mask_ratio=0.25))
    # no committee at all: nothing to check
    tst.make_selftrain_step(pair.sm, pair.cm, pair.tm, device="cpu",
                            train_masked=False, selection_strategy="conf",
                            **dict(GEOM, mask_ratio=0.25))
    with pytest.raises(ValueError, match="Invalid selection strategy"):
        tst.make_selftrain_step(pair.sm, pair.cm, pair.tm, device="cpu",
                                selection_strategy="vote", **GEOM)
    step = tst.make_selftrain_step(pair.sm, pair.cm, pair.tm, device="cpu",
                                   **GEOM)
    batch = to_torch(batch_np(40))
    batch["clip_sim"] = batch["clip_sim"][:, :10]
    with pytest.raises(ValueError, match="clip_sim width 10"):
        step(pair.port_state(1e-4, 0.05), batch)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_committee_masks_with_ties(seed):
    rng = np.random.default_rng(seed)
    attn = rng.integers(0, 4, (12, 196)).astype(np.float32)  # many ties
    attn[3] = 0.5
    for ratio, k in ((0.8, 2), (0.5, 2), (0.7, 3)):
        ref = np.asarray(jmask.greedy_committee_masks(jnp.asarray(attn),
                                                      ratio, k))
        got = tmask.greedy_committee_masks(torch.from_numpy(attn), ratio, k)
        assert got.dtype == torch.bool and got.shape == (k, 12, 196)
        np.testing.assert_array_equal(got.numpy(), ref)
        nv = tmask.n_visible(196, ratio)
        assert ((~got).sum(-1) == nv).all()
        assert not ((~got).sum(0) > 1).any()  # disjoint


@pytest.mark.parametrize("use_cls_token", [False, True])
def test_eval_step_matches_jax(use_cls_token):
    pair = Pair(use_cls_token)
    rng = np.random.default_rng(50)
    vids = rng.integers(0, 256, (3, 4, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 7, 11], np.int32)
    jeval = jst.make_selftrain_eval_step(pair.sj, pair.cj, use_cls_token,
                                         with_feats=True)
    jstate = SimpleNamespace(params={"model": pair.sp, "classifier": pair.hp})
    ref = jeval(jstate, {"videos": jnp.asarray(vids),
                         "labels": jnp.asarray(labels)})
    ev = tst.make_selftrain_eval_step(pair.sm, pair.cm, use_cls_token,
                                      with_feats=True, device="cpu")
    out = ev(None, {"videos": torch.from_numpy(vids),
                    "labels": torch.from_numpy(labels)})
    assert set(out) == set(ref)
    for k in ("probs", "feats", "loss", "acc1", "acc5"):
        np.testing.assert_allclose(out[k].numpy(), _np(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["probs"].sum(-1).numpy(), 1.0, rtol=1e-6)


def test_pooling_zero_shot_and_prediction_table():
    rng = np.random.default_rng(60)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    for cls in (False, True):
        np.testing.assert_allclose(
            tst.pool_outputs(torch.from_numpy(x), cls).numpy(),
            _np(jst.pool_outputs(jnp.asarray(x), cls)), rtol=1e-6)
    img = rng.standard_normal((2, 4, 16)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt = rng.standard_normal((12, 16)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tst.clip_zero_shot_similarities(torch.from_numpy(img),
                                        torch.from_numpy(txt)).numpy(),
        _np(jst.clip_zero_shot_similarities(jnp.asarray(img),
                                            jnp.asarray(txt))),
        rtol=1e-5, atol=1e-7)
    logits = rng.standard_normal((40, 12)).astype(np.float32)
    sims = rng.standard_normal((40, 12)).astype(np.float32)
    target = rng.integers(0, 12, 40)
    want = jst.compare_model_predictions(logits, sims, target)
    assert tst.compare_model_predictions(
        torch.from_numpy(logits), torch.from_numpy(sims), target) == want
    assert tst.compare_model_predictions(logits.argmax(-1), sims,
                                         torch.from_numpy(target)) == want


def test_trainable_mask_follows_the_args():
    pair = Pair(use_cls_token=True)
    names = [n for n, _ in pair.model.named_parameters()]
    mask = trun3.trainable_mask(ARGS, pair.model)
    assert [n for n in names if not mask[n]] == ["classifier.weight",
                                                 "classifier.bias"]
    frozen_dec = SimpleNamespace(**dict(vars(ARGS), freeze_clip_decoders=True))
    mask = trun3.trainable_mask(frozen_dec, pair.model)
    assert {n for n in names if not mask[n]} == {
        "classifier.weight", "classifier.bias"} | {
        n for n in names if n.startswith("model.clip_decoder.")}
    _, groups = trun3.build_optimizer(ARGS, pair.model, 1e-4, 0.05,
                                      device="cpu")
    _, _, jgroups = jfactory.param_group_metadata(
        {"model": pair.sp, "classifier": pair.hp}, 0.05, trainable_mask={
            "model": jax.tree.map(lambda _: True, pair.sp),
            "classifier": jax.tree.map(lambda _: False, pair.hp)})
    names = {".".join(k): n for k, n in zip(
        flatten({"model": pair.sp}),
        ["model." + n for n in flax_to_state_dict(pair.sp)])}
    names.update({"classifier.kernel": "classifier.weight",
                  "classifier.bias": "classifier.bias"})
    assert set(groups) == set(jgroups) == {"decay", "no_decay", "frozen"}
    for g, meta in groups.items():
        assert sorted(meta["params"]) == sorted(
            names[p] for p in jgroups[g]["params"]), g
        assert meta["lr_scale"] == jgroups[g]["lr_scale"]
    assert "model.encoder.cls_token" in groups["no_decay"]["params"]
