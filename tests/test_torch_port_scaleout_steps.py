"""The three stage steps of unite_torch under every scale-out layout, on
ranks over gloo on the CPU, against unite_tpu's one-device step and the
port's one-process step on the same global batch.

Each stage runs two steps, fp32, Adam's eps 1e-6 (tests/test_torch_port_step
says why), drop path 0 with the masks injected (stage 1's visible tokens,
stage 3's teacher attention and CLIP similarities): under DDP, --zero1 and
--fsdp on 2 ranks, and under --tp 2 and --tp 2 --zero1 on 4 (2 replicas of
2). Each replica takes its rows of the global batch: stage 1 a source and a
target clip (the loss normalised by the target rows' count, equal on every
rank, so DDP's mean of the ranks' losses is the global one), stage 2 two
clips, stage 3 a source clip and two target clips (fixed denominators). The
gate, within 1e-5 relative (the bars of ``__graft_entry__.py``'s dryrun and
MULTICHIP_r05.json): the global loss and the grad norm of every step (the
whole model's, also where FSDP and TP hold pieces), every parameter after
the two steps (each tensor within 1e-5 of its norm, its update within 1e-3
of the update's norm, as tests/test_torch_port_step.py bounds updates), and
stage 2's EMA; the moments against the one-process run's.
Stage 1 clips its gradient at 0.05, so a wrong norm moves the parameters.

Checkpoints: the one a layout's rank 0 writes (every tensor whole) loads into
a fresh state of the same layout, and into one process, with params,
moments and EMA bit for bit what the layout held; ZeRO-1 and FSDP hold about
half of DDP's moment bytes a rank.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from tests.test_torch_port_scaleout_layout import (
    EMA, EPS, LAYOUTS, S1_GEOM, S1_STUDENT, S1_TEACHER, S2_ARGS, S2_VIT,
    S3_GEOM, S3_STUDENT, S3_TEACHER, WORLD, build_stage, launch)
from unite_tpu.engines import finetune as jft
from unite_tpu.engines import selftrain as jst
from unite_tpu.engines.pretrain_umt import make_pretrain_train_step as j1step
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.models import vit as jvit
from unite_tpu.optim import factory as jfactory
from unite_tpu.train import run_stage2 as jrun2
from unite_tpu.train.run_stage1 import unused_block_mask
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck
from unite_torch.utils.flax_bridge import flax_to_state_dict

LR = jsched.cosine_scheduler(5e-4, 2.5e-5, 1, 3, warmup_steps=1,
                             start_warmup_value=2.5e-4)
WD = jsched.cosine_scheduler(0.05, 0.2, 1, 3)
REPLICAS = 2
# this file holds stage 1; tests/test_torch_port_scaleout_stage{2,3}.py the
# others, with the same checks (one file a stage spreads them over the
# test workers)
STAGE = "stage1"


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _videos(rng, b):
    return rng.integers(0, 256, (b, 4, 32, 32, 3), dtype=np.uint8)


def _vis_idx(rng, b):
    return np.stack([np.sort(np.concatenate(
        [f * 4 + rng.choice(4, 2, replace=False) for f in range(4)]))
        for _ in range(b)]).astype(np.int32)


def stage1():
    sj = jad.AdaptationVisionTransformer(**S1_STUDENT)
    tj = jclip.CLIPVisionTransformer(**S1_TEACHER)
    x = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    sp = perturb(sj.init(jax.random.PRNGKey(0), x,
                         jnp.zeros((1, 8), jnp.int32), False)["params"], 1)
    tp = perturb(tj.init(jax.random.PRNGKey(1), x)["params"], 2)
    weights = {"student": flax_to_state_dict(sp),
               "teacher": flax_to_state_dict(tp, kind="clip")}
    batches = []
    for i in range(2):
        rng = np.random.default_rng(10 + i)
        # each replica: one source clip, then one target clip
        batches.append({"videos": _videos(rng, 2 * REPLICAS),
                        "vis_idx": _vis_idx(rng, 2 * REPLICAS),
                        "src_mask": np.tile(np.array([1, 0], np.float32),
                                            REPLICAS)})
    rows = {"videos": 2, "vis_idx": 2, "src_mask": 2}

    def run_jax():
        tx, _ = jfactory.create_optimizer(
            "adamw", lr=LR, params=sp, weight_decay=WD, betas=(0.9, 0.95),
            eps=EPS, trainable_mask=unused_block_mask(sp, 1))
        state = JaxTrainState.create(jax.tree.map(jnp.asarray, sp), tx)
        step = jax.jit(j1step(sj, tj, **S1_GEOM))
        metrics = []
        for b in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, tp),
                            {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(0))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        return flax_to_state_dict(jax.tree.map(np.asarray, state.params)), \
            metrics, None

    return weights, batches, rows, run_jax


def stage2():
    jm = jvit.VisionTransformer(**S2_VIT)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, 4, 32, 32, 3), jnp.float32))["params"], 1)
    weights = {"vit": flax_to_state_dict(p)}
    batches = []
    for i in range(2):
        rng = np.random.default_rng(20 + i)
        batches.append({"videos": _videos(rng, 2 * REPLICAS),
                        "labels": rng.integers(0, 12, 2 * REPLICAS).astype(
                            np.int32)})
    rows = {"videos": 2, "labels": 2}

    def run_jax():
        tx, _ = jfactory.create_optimizer(
            "adamw", lr=LR, params=p, weight_decay=WD, betas=(0.9, 0.999),
            eps=EPS, num_layers=2, layer_decay=0.65,
            trainable_mask=jrun2.trainable_mask(S2_ARGS, p))
        state = JaxTrainState.create(jax.tree.map(jnp.asarray, p), tx,
                                     ema_decay=EMA)
        step = jax.jit(jft.make_finetune_train_step(jm, ema_decay=EMA))
        metrics = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(0))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        to_sd = lambda t: flax_to_state_dict(jax.tree.map(np.asarray, t))
        return to_sd(state.params), metrics, to_sd(state.ema_params)

    return weights, batches, rows, run_jax


def stage3():
    sj = jad.AdaptationVisionTransformer(**S3_STUDENT)
    tj = jclip.CLIPVisionTransformer(**S3_TEACHER)
    cj = fnn.Dense(12, param_dtype=jnp.float32, dtype=jnp.float32)
    x = jnp.zeros((1, 4, 32, 32, 3))
    sp = perturb(sj.init(jax.random.PRNGKey(0), x)["params"], 1)
    tp = perturb(tj.init(jax.random.PRNGKey(1), x)["params"], 2)
    hp = perturb(cj.init(jax.random.PRNGKey(2), jnp.zeros((1, 128)))[
        "params"], 3)
    weights = {"student": flax_to_state_dict(sp),
               "teacher": flax_to_state_dict(tp, kind="clip"),
               "classifier": {
                   "weight": torch.from_numpy(hp["kernel"].T.copy()),
                   "bias": torch.from_numpy(hp["bias"].copy())}}
    b_s, b_t = REPLICAS, 2 * REPLICAS
    batches = []
    for i in range(2):
        rng = np.random.default_rng(30 + i)
        logits = rng.standard_normal((b_t, 12)) * np.array(
            [[3.0], [0.1]] * REPLICAS)
        sim = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        batches.append({
            "videos_s": _videos(rng, b_s),
            "labels_s": rng.integers(0, 12, b_s).astype(np.int32),
            "videos_t": _videos(rng, b_t), "videos_t_aug": _videos(rng, b_t),
            "labels_t": rng.integers(0, 12, b_t).astype(np.int32),
            "classwise_thresholds": rng.uniform(0.0, 0.3, 12).astype(
                np.float32),
            "clip_sim": sim.astype(np.float32),
            # the teacher's CLS attention, [B_t * frames, patches a frame]
            "attn": rng.dirichlet(np.ones(4), size=b_t * 4).astype(
                np.float32)})
    rows = {"videos_s": 1, "labels_s": 1, "videos_t": 2, "videos_t_aug": 2,
            "labels_t": 2, "clip_sim": 2, "attn": 8}

    def run_jax():
        params = {"model": sp, "classifier": hp}
        mask = {"model": jax.tree.map(lambda _: True, sp),
                "classifier": jax.tree.map(lambda _: False, hp)}
        tx, _ = jfactory.create_optimizer(
            "adamw", lr=LR, params=params, weight_decay=WD,
            betas=(0.9, 0.95), eps=EPS, trainable_mask=mask)
        state = JaxTrainState.create(jax.tree.map(jnp.asarray, params), tx)
        step = jax.jit(jst.make_selftrain_step(sj, cj, tj, **S3_GEOM))
        metrics = []
        for b in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, tp),
                            {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(0))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        q = jax.tree.map(np.array, state.params)
        out = {f"model.{k}": v
               for k, v in flax_to_state_dict(q["model"]).items()}
        out["classifier.weight"] = torch.from_numpy(q["classifier"]["kernel"].T)
        out["classifier.bias"] = torch.from_numpy(q["classifier"]["bias"])
        return out, metrics, None

    return weights, batches, rows, run_jax


BUILDERS = {"stage1": stage1, "stage2": stage2, "stage3": stage3}


def port_one_process(stage, weights, batches):
    """The port's step in this process, no process group, on the global
    batches: (state, metrics)."""
    model, opt, make_step, ema = build_stage(stage, weights)
    state = TrainState(model, opt(model), ema_decay=ema)
    step = make_step()
    metrics = []
    for b in batches:
        m = step(state, {k: torch.from_numpy(np.asarray(v))
                         for k, v in b.items()})
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return state, metrics


class Cache:
    """Each stage's references and its ranks' results, computed once."""

    def __init__(self, tmp_factory):
        self.tmp, self.runs, self.refs = tmp_factory, {}, {}

    def ref(self, stage):
        if stage not in self.refs:
            weights, batches, rows, run_jax = BUILDERS[stage]()
            weights.update(lr=LR, wd=WD)
            jparams, jmetrics, jema = run_jax()
            state, metrics = port_one_process(stage, weights, batches)
            self.refs[stage] = dict(
                weights=weights, batches=batches, rows=rows, jparams=jparams,
                jmetrics=jmetrics, jema=jema, state=state, metrics=metrics)
        return self.refs[stage]

    def run(self, stage, world):
        key = (stage, world)
        if key not in self.runs:
            r = self.ref(stage)
            names = [n for n, w in WORLD.items() if w == world]
            payload = {"stage": stage, "layouts": names,
                       "weights": r["weights"], "batches": r["batches"],
                       "rows": r["rows"]}
            out = launch(world, "steps", self.tmp.mktemp(f"{stage}_w{world}"),
                         payload, timeout=240)
            self.runs[key] = out
        return self.runs[key]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return Cache(tmp_path_factory)


def close(got, ref, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _initial_params(stage, weights):
    model = build_stage(stage, weights)[0]
    return {k: v.clone() for k, v in model.state_dict().items()}


def _one_process_moments(state):
    named = dict(state.model.named_parameters())
    return {n: state.optimizer.state[p] for n, p in named.items()
            if state.optimizer.state.get(p)}


def check_step(cache, stage, layout):
    ref = cache.ref(stage)
    ranks = cache.run(stage, WORLD[layout])
    res = ranks[0][layout]
    assert res["layout"] == {"ddp": "ddp", "zero1": "zero1", "fsdp": "fsdp",
                             "tp2": "tp", "tp2_zero1": "tp+zero1"}[layout]
    for i, (m, jm, pm1) in enumerate(zip(res["metrics"], ref["jmetrics"],
                                         ref["metrics"])):
        for k in ("loss", "grad_norm"):
            close(m[k], jm[k], atol=0, what=f"step {i} {k} vs JAX")
            close(m[k], pm1[k], atol=0, what=f"step {i} {k} vs one process")
    full = res["full"]
    one = {k: v for k, v in ref["state"].model.state_dict().items()}
    init = _initial_params(stage, ref["weights"])
    assert set(full["params"]) == set(ref["jparams"]) == set(one)
    for k, v in full["params"].items():
        for want, what in ((ref["jparams"][k], "JAX"), (one[k], "one process")):
            want = torch.as_tensor(np.asarray(want))
            # each tensor within 1e-5 of its norm, and its update within
            # 1e-3 of the update's: fp32 summation order differs between the
            # ranks' sums and one device's, and Adam turns the noise of a
            # near-zero gradient into an O(1) change of its element's update
            assert (v - want).norm() <= 1e-5 * want.norm(), (k, what)
            du, dw = v - init[k], want - init[k]
            assert (du - dw).norm() <= 1e-3 * dw.norm() + 1e-12, (k, what)
    # every rank holds the same whole state
    for other in ranks[1:]:
        for k, v in other[layout]["full"]["params"].items():
            assert torch.equal(v, full["params"][k]), k
    if ref["jema"] is not None:
        for k, v in full["ema"].items():
            close(v, ref["jema"][k], what=f"EMA {k} vs JAX")
    moments = _one_process_moments(ref["state"])
    assert set(full["moments"]) == set(moments)
    for n, mom in moments.items():
        for k, v in mom.items():
            d = (full["moments"][n][k] - v).norm()
            assert d <= 1e-4 * v.norm() + 1e-12, (n, k)


def check_checkpoint(cache, stage, layout):
    ref = cache.ref(stage)
    res = cache.run(stage, WORLD[layout])[0][layout]
    full, again = res["full"], res["again"]
    # into a fresh state of the same layout, on every rank
    for part in ("params", "ema"):
        for k, v in (full[part] or {}).items():
            assert torch.equal(again[part][k], v), (part, k)
    for n, mom in full["moments"].items():
        for k, v in mom.items():
            assert torch.equal(again["moments"][n][k], v), (n, k)
    # into one process
    model, opt, _, ema = build_stage(stage, ref["weights"])
    state = TrainState(model, opt(model), ema_decay=ema)
    payload = ck.load_checkpoint(f"{res['ckpt']}/checkpoint-latest.pth")
    ck.restore_train_state(state, payload)
    for k, v in model.state_dict().items():
        assert torch.equal(v, full["params"][k]), k
    for n, mom in _one_process_moments(state).items():
        for k, v in mom.items():
            assert torch.equal(v, full["moments"][n][k]), (n, k)
    if ema is not None:
        for k, v in state.ema_params.items():
            assert torch.equal(v, full["ema"][k]), k
    assert state.step == 2 and state.optimizer.count == 2


def check_moment_bytes(cache, stage):
    ranks = cache.run(stage, 2)
    ddp = ranks[0]["ddp"]["moment_bytes"]
    for layout in ("zero1", "fsdp"):
        per_rank = [r[layout]["moment_bytes"] for r in ranks]
        assert sum(per_rank) <= 1.02 * ddp, (layout, per_rank, ddp)
        assert max(per_rank) <= 0.6 * ddp, (layout, per_rank, ddp)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_step_matches_jax_and_one_process(cache, layout):
    check_step(cache, STAGE, layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_checkpoint_loads_bit_for_bit(cache, layout):
    check_checkpoint(cache, STAGE, layout)


def test_sharded_moments_take_about_half_a_rank(cache):
    check_moment_bytes(cache, STAGE)
