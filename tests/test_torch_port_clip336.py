"""unite_torch's ``clip_l14_336`` as the stage-3 zero-shot teacher against
unite_tpu's, on the CPU.

``clip_l14_336`` (24 blocks of 1024, 16 heads of 64, patch 14) runs at its
native 336^2 as the stage-3 zero-shot teacher: each frame is 24^2 patches
plus its CLS, 577 tokens, a prime, so no block size divides it and every
block takes ``multi_head_attention`` (K6 on the card; on the CPU the plain
version on the port's side and XLA's attention on JAX's). The numbers come
from the teacher cut to 2 blocks at full width, fp32, held to JAX at 1e-5
relative (the features, the similarities); the full-depth tower is
compared on ``meta`` and under ``jax.eval_shape`` only.

Two faults of the reference show here, and the port repairs both
(ROADMAP queue 3, item 8):

* ``unite_tpu``'s ``clip_l14_336`` factory fixes ``input_resolution`` and
  raises a TypeError when ``run_stage1.build_teacher`` passes
  ``--clip_input_resolution``, as it always does; the port's factory takes
  it (336 by default);
* the stage-3 committee ranks the teacher's CLS-row attention over the
  teacher's grid and gathers the student's tokens with those indices. On
  another grid than the student's (24^2 against 14^2 at 336) JAX's gather
  fills the indices past the student's tokens with NaN and its loss is
  NaN; the port raises a ValueError before the gather. Without a committee
  (``train_masked=False`` with a strategy that casts no votes, such as
  ``clip_matchORconf``) any teacher grid serves, and the step matches JAX.

The stage-3 steps use tiny widths: a /16 student over 4 frames of 32^2 (a
2^2 grid) beside a patch-14 teacher at 42^2 (a 3^2 grid), the geometry of
the 336 teacher against the 224 student cut down. The stage-1 import of a
336 OpenAI visual state at --clip_input_resolution 196 resamples its
577-row positional table to 197 rows on both sides, at a narrow width.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as JA
import unite_torch.ops.attention as TA
from unite_tpu.engines import pretrain_umt as jpre
from unite_tpu.engines import selftrain as jst
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.models import clip_text as jtext
from unite_tpu.optim import factory as jfactory
from unite_tpu.train import run_stage1 as jrun1
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_tpu.utils import torch_import as jti
from unite_torch import create_model
from unite_torch.engines import pretrain_umt as tpre
from unite_torch.engines import selftrain as tst
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.models import clip_text as ttext
from unite_torch.train import run_stage1 as trun1
from unite_torch.train import run_stage3 as trun3
from unite_torch.train.train_state import TrainState
from unite_torch.utils import torch_import as tti
from unite_torch.utils.flax_bridge import clip_key, flax_to_state_dict

# clip_l14_336 at full width, cut to 2 blocks
L336_CUT = dict(input_resolution=336, patch_size=14, width=1024, layers=2,
                heads=16, output_dim=768, return_attn=True, return_index=(1,))


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def rel_err(got, ref) -> float:
    got = np.asarray(torch.as_tensor(got).detach().float())
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def teacher_336():
    """The cut teacher in both packages, the same weights (jitted JAX
    init; the bridge carries them over)."""
    tj = jclip.CLIPVisionTransformer(**L336_CUT)
    tp = perturb(jax.jit(tj.init)(jax.random.PRNGKey(1), jnp.zeros(
        (1, 1, 336, 336, 3)))["params"], 2)
    tm = tclip.CLIPVisionTransformer(**L336_CUT)
    tm.load_state_dict(flax_to_state_dict(tp, kind="clip", patch_size=14),
                       strict=True)
    return tj, jax.tree.map(jnp.asarray, tp), tm.eval()


# ------------------------------------------------------------ geometry

def test_full_clip_l14_336_builds_as_jax_on_meta():
    tm = create_model("clip_l14_336", device="meta", return_index=(6,))
    jm = jclip.clip_l14_336(return_index=(6,))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 1, 336, 336, 3),
                                                 jnp.float32))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    mapped = {}
    for path, leaf in flat:
        names = tuple(p.key for p in path)
        key, val = clip_key(names, np.broadcast_to(np.float32(0), leaf.shape),
                            14)
        mapped[key] = tuple(val.shape)
    state = tm.state_dict()
    assert set(mapped) == set(state)
    for k, shape in mapped.items():
        assert tuple(state[k].shape) == shape, k
    assert tm.input_resolution == 336 and tm.patch_size == 14
    assert tm.positional_embedding.shape == (577, 1024)
    assert len(tm.transformer.resblocks) == 24
    assert tm.transformer.resblocks[0].attn.num_heads == 16
    assert tm.proj.shape == (1024, 768)
    assert sum(p.numel() for p in tm.parameters()) > 3e8


def test_577_tokens_take_the_k6_route_in_both_packages():
    # 577 is prime: no multiple-of-8 divisor block, so neither package's
    # fused qkv route takes it and both send it to multi_head_attention
    assert not JA.use_fused_qkv(577, fwd_only=True)
    assert not TA.use_fused_qkv(577, fwd_only=True)
    assert 577 > TA.GROUPED_MAX_SEQ  # K6, not K5


def test_build_teacher_takes_the_336_teacher_where_jax_raises():
    # run_stage1.build_teacher always passes --clip_input_resolution;
    # unite_tpu's factory fixes it, so the 336 teacher never builds there
    args = SimpleNamespace(clip_return_attn=True, clip_teacher="clip_l14_336",
                           clip_norm_type="l2", clip_return_layers=[6],
                           compute_dtype="bfloat16", tp=1,
                           clip_input_resolution=336)
    with pytest.raises(TypeError, match="input_resolution"):
        jrun1.build_teacher(args)
    for res, rows in ((336, 577), (196, 197)):
        args.clip_input_resolution = res
        t = trun1.build_teacher(args, device="meta")
        assert (t.input_resolution, t.patch_size) == (res, 14)
        assert t.positional_embedding.shape == (rows, 1024)


# ---------------------------------------------------- (a), (b), (c)

def test_cls_features_at_336_match_jax(teacher_336):
    tj, tp, tm = teacher_336
    x = np.random.default_rng(3).standard_normal(
        (1, 2, 336, 336, 3)).astype(np.float32)
    ref = _np(tj.apply({"params": tp}, jnp.asarray(x), None, True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), cls_features=True)
    assert got.shape == (2, 768) and ref.shape == (2, 768)
    assert rel_err(got, ref) <= 1e-5
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_resize_for_teacher_upscales_224_to_336_as_jax(dtype):
    # every earlier cell resized down (224 -> 196) or not at all. A uint8
    # clip, as the zero-shot call takes it, is normalized to bf16 first on
    # both sides; the resize computes in fp32 (summation orders differ by
    # under 1e-6) and rounds to bf16, so a value that lands on the other
    # side of a rounding boundary is one bf16 ulp (at most 2^-7 of it) off
    # JAX's, and few do
    from unite_tpu.ops.normalize import normalize_videos as jnorm
    from unite_torch.ops.normalize import normalize_videos as tnorm

    rng = np.random.default_rng(4)
    if dtype == "uint8":
        raw = rng.integers(0, 256, (1, 2, 224, 224, 3), dtype=np.uint8)
        jx, tx = jnorm(jnp.asarray(raw)), tnorm(torch.from_numpy(raw))
    else:
        x = rng.standard_normal((1, 2, 224, 224, 3)).astype(np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ref = _np(jpre.resize_for_teacher(jx, 336))
    got = tpre.resize_for_teacher(tx, 336)
    assert got.shape == (1, 2, 336, 336, 3)
    assert got.dtype == (torch.bfloat16 if dtype == "uint8"
                         else torch.float32)
    if dtype == "uint8":
        diff = np.abs(got.float().numpy() - ref)
        assert np.all(diff <= np.abs(ref) * 2.0 ** -7 + 1e-6)
        assert (diff > 0).mean() <= 1e-3
    else:
        assert rel_err(got, ref) <= 1e-5


def test_zero_shot_fn_at_336_matches_jax(teacher_336, tmp_path):
    tj, tp, tm = teacher_336
    np.save(tmp_path / "feats768.npy", np.random.default_rng(5)
            .standard_normal((12, 768)).astype(np.float32))
    args = SimpleNamespace(clip_text_features=str(tmp_path / "feats768.npy"),
                           clip_input_resolution=336, nb_classes=12)
    videos = np.random.default_rng(6).integers(
        0, 256, (2, 2, 224, 224, 3), dtype=np.uint8)
    ref = _np(jtext.build_zero_shot_fn(args, tj, tp)(jnp.asarray(videos)))
    got = ttext.build_zero_shot_fn(args, tm)(torch.from_numpy(videos))
    assert got.shape == (2, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert rel_err(got, ref) <= 1e-5


# ---------------------------------------------------- (d), (e)

STUDENT = dict(img_size=32, patch_size=16, encoder_embed_dim=128,
               encoder_depth=2, encoder_num_heads=2, num_frames=4,
               tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=96,
               clip_return_layers=(1,))
# a 3^2 grid (patch 14 at 42^2) beside the student's 2^2, as the 336
# teacher's 24^2 beside the 224 student's 14^2
TEACHER = dict(input_resolution=42, patch_size=14, width=192, layers=2,
               heads=12, output_dim=96, return_attn=True, return_index=(1,))
# the student's grid: 2^2 at 32^2 (the repaired check's passing case)
SAME_GRID = dict(TEACHER, input_resolution=28)
# clip_threshold 0.9, as tests/test_torch_port_vit_l.py: the zero-shot rows
# of random text features are confident and the student's are not
GEOM = dict(num_patches=16, frames=4, mask_ratio=0.5, nb_classes=12,
            clip_threshold=0.9, selection_strategy="clip_matchORconf")
ARGS3 = SimpleNamespace(opt="adamw", opt_betas=[0.9, 0.95], opt_eps=1e-6,
                        nb_classes=12, freeze_clip_decoders=False,
                        src_classifier_type="linear")


class Stage3:
    """The student, a teacher of ``teacher``'s geometry and the classifier
    in both packages, with the same weights."""

    def __init__(self, teacher=TEACHER):
        res = teacher["input_resolution"]
        self.sj = jad.AdaptationVisionTransformer(**STUDENT)
        self.tj = jclip.CLIPVisionTransformer(**teacher)
        self.cj = fnn.Dense(12, param_dtype=jnp.float32, dtype=jnp.float32)
        self.sp = perturb(jax.jit(self.sj.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)))["params"], 1)
        self.tp = perturb(jax.jit(self.tj.init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 4, res, res, 3)))["params"],
            2)
        self.hp = perturb(self.cj.init(jax.random.PRNGKey(2),
                                       jnp.zeros((1, 128)))["params"], 3)
        self.sm = tad.AdaptationVisionTransformer(**STUDENT)
        self.sm.load_state_dict(flax_to_state_dict(self.sp), strict=True)
        self.tm = tclip.CLIPVisionTransformer(**teacher)
        self.tm.load_state_dict(flax_to_state_dict(self.tp, kind="clip",
                                                   patch_size=14), strict=True)
        self.cm = trun3.build_classifier(ARGS3, 128, device="cpu")
        self.cm.load_state_dict({
            "weight": torch.from_numpy(self.hp["kernel"].T.copy()),
            "bias": torch.from_numpy(self.hp["bias"].copy())})
        self.model = trun3.combine(self.sm, self.cm)
        self.geom = dict(GEOM, clip_input_resolution=res)

    def jax_state(self, lr, wd):
        params = {"model": self.sp, "classifier": self.hp}
        tx, _ = jfactory.create_optimizer(
            "adamw", lr=lr, params=params, weight_decay=wd,
            betas=(0.9, 0.95), eps=1e-6, trainable_mask={
                "model": jax.tree.map(lambda _: True, self.sp),
                "classifier": jax.tree.map(lambda _: False, self.hp)})
        return JaxTrainState.create(jax.tree.map(jnp.asarray, params), tx)

    def jax_step(self, **kw):
        return jax.jit(jst.make_selftrain_step(self.sj, self.cj, self.tj,
                                               **dict(self.geom, **kw)))

    def port_step(self, **kw):
        return tst.make_selftrain_step(self.sm, self.cm, self.tm,
                                       device="cpu", **dict(self.geom, **kw))


def stage3_batch(seed, b_s=2, b_t=4):
    rng = np.random.default_rng(seed)

    def vid(b):
        return rng.integers(0, 256, (b, 4, 32, 32, 3), dtype=np.uint8)

    return {"videos_s": vid(b_s),
            "labels_s": rng.integers(0, 12, b_s).astype(np.int32),
            "videos_t": vid(b_t), "videos_t_aug": vid(b_t),
            "labels_t": rng.integers(0, 12, b_t).astype(np.int32),
            "classwise_thresholds": np.zeros(12, np.float32)}


def test_unmasked_step_with_another_teacher_grid_matches_jax(tmp_path):
    # --train_masked false with clip_matchORconf: no committee, so the
    # teacher serves only the zero-shot similarities, on its own grid
    pair = Stage3()
    np.save(tmp_path / "feats96.npy", np.random.default_rng(7)
            .standard_normal((12, 96)).astype(np.float32))
    zs_args = SimpleNamespace(clip_text_features=str(tmp_path / "feats96.npy"),
                              clip_input_resolution=42, nb_classes=12)
    jzs = jtext.build_zero_shot_fn(zs_args, pair.tj,
                                   jax.tree.map(jnp.asarray, pair.tp))
    tzs = ttext.build_zero_shot_fn(zs_args, pair.tm)
    lr = jsched.cosine_scheduler(5e-4, 2.5e-5, 1, 3, warmup_steps=1,
                                 start_warmup_value=2.5e-4)
    wd = jsched.cosine_scheduler(0.05, 0.2, 1, 3)
    jstate = pair.jax_state(lr, wd)
    otx, _ = trun3.build_optimizer(ARGS3, pair.model, lr, wd, device="cpu")
    state = TrainState(pair.model, otx)
    jstep = pair.jax_step(train_masked=False)
    step = pair.port_step(train_masked=False)
    tp = jax.tree.map(jnp.asarray, pair.tp)
    for i in range(2):
        batch = stage3_batch(10 + i)
        sim_j = _np(jzs(jnp.asarray(batch["videos_t"])))
        assert rel_err(tzs(torch.from_numpy(batch["videos_t"])), sim_j) \
            <= 1e-5
        batch["clip_sim"] = sim_j
        jstate, jm = jstep(jstate, tp, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        m = step(state, {k: torch.from_numpy(np.asarray(v))
                         for k, v in batch.items()})
        assert set(jm) == set(m)
        for k in jm:
            if k in ("loss", "grad_norm", "loss_class", "loss_class_t"):
                np.testing.assert_allclose(m[k].item(), float(jm[k]),
                                           rtol=1e-5, err_msg=k)
            else:  # the selection and per-sample predictions: exact
                np.testing.assert_array_equal(m[k].numpy(),
                                              np.asarray(jm[k]), err_msg=k)
        assert np.isfinite(float(jm["loss"]))
    jp = jax.tree.map(np.array, jstate.params)
    for k, v in flax_to_state_dict(jp["model"]).items():
        np.testing.assert_allclose(
            pair.model.state_dict()[f"model.{k}"].numpy(), v.numpy(),
            rtol=1e-5, atol=1e-6, err_msg=k)
    assert state.step == 2


def committee_attn(b_t=4, frames=4):
    """Injected teacher attention [B_t*T, 9] on the 3^2 grid, ranking the
    positions 0, 5, 1, 6, 2, 7, 3, 8, 4: the grad member (k-1 = 1 of a
    committee of 2) takes every other rank, positions 5-8 of each frame.
    Over 4 frames of 9 those are 5-8, 14-17, ...: the first 8 (the
    student's 8 visible of 16 tokens) hold 16 and 17, past its tokens."""
    rank = np.array([0, 2, 4, 6, 8, 1, 3, 5, 7])
    return np.tile((9 - rank).astype(np.float32) / 45.0, (b_t * frames, 1))


def test_grid_mismatch_gives_nan_in_jax_and_a_valueerror_in_the_port():
    pair = Stage3()
    batch = dict(stage3_batch(20), attn=committee_attn())
    batch["clip_sim"] = np.full((4, 12), 1 / 12, np.float32)
    jstate = pair.jax_state(1e-4, 0.05)
    _, jm = pair.jax_step(train_masked=True)(
        jstate, jax.tree.map(jnp.asarray, pair.tp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    assert np.isnan(float(jm["loss"]))
    # the port refuses the geometry when it builds the step
    with pytest.raises(ValueError, match=r"teacher patch grid \(9/frame\) != "
                                         r"student grid \(4/frame\)"):
        pair.port_step(train_masked=True)
    # a voting strategy needs the committee without train_masked too
    with pytest.raises(ValueError, match="--train_masked false"):
        pair.port_step(train_masked=False, selection_strategy="consORconf")


def test_injected_attention_on_another_grid_raises_before_the_gather():
    # a teacher on the student's grid, fed an attention row of a 3^2 grid
    # through the injection hook: the step refuses it before any gather,
    # where JAX's gives NaN (the test above)
    pair = Stage3(SAME_GRID)
    step = pair.port_step(train_masked=True)
    otx, _ = trun3.build_optimizer(ARGS3, pair.model, 1e-4, 0.05,
                                   device="cpu")
    batch = dict(stage3_batch(20), attn=committee_attn())
    batch["clip_sim"] = np.full((4, 12), 1 / 12, np.float32)
    before = {k: v.clone() for k, v in pair.model.state_dict().items()}
    with pytest.raises(ValueError, match=r"\(9/frame\) != student grid"):
        step(TrainState(pair.model, otx),
             {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for k, v in pair.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------- (f)

def test_stage1_import_of_a_336_state_at_196_matches_jax():
    # an OpenAI-layout visual state of the 336 geometry (577-row table,
    # 2-D 14x14 patch weights) at a narrow width, imported at 196^2: the
    # table resampled 24^2 -> 14^2 (197 rows) on both sides, and the
    # teacher's taps and CLS-row attention equal
    geom = dict(patch_size=14, width=64, layers=2, heads=4, output_dim=32,
                return_attn=True, return_index=(0, 1))
    torch.manual_seed(8)
    src = tclip.CLIPVisionTransformer(input_resolution=336, **geom)
    state = {k: v.clone() for k, v in src.state_dict().items()}
    state["conv1.weight"] = state["conv1.weight"][:, :, 0]
    assert state["positional_embedding"].shape == (577, 64)
    assert state["conv1.weight"].shape == (64, 3, 14, 14)
    got = tti.clip_state_for_model(state, input_resolution=196,
                                   patch_size=14)
    params = jti.clip_state_to_flax_params(state, input_resolution=196,
                                           patch_size=14)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, params), kind="clip",
                             patch_size=14)
    assert got["positional_embedding"].shape == (197, 64)
    assert set(ref) <= set(got)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   ref[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    tm = tclip.CLIPVisionTransformer(input_resolution=196, **geom)
    missing, unexpected = tti.merge_state(tm, got)
    assert not missing and not unexpected
    tj = jclip.CLIPVisionTransformer(input_resolution=196, **geom)
    x = np.random.default_rng(9).standard_normal(
        (1, 2, 196, 196, 3)).astype(np.float32)
    z_ref, attn_ref = tj.apply({"params": jax.tree.map(jnp.asarray, params)},
                               jnp.asarray(x))
    with torch.no_grad():
        z, attn = tm(torch.from_numpy(x))
    assert z.shape == (2, 1, 2 * 196, 32) and attn.shape == (2, 196)
    assert rel_err(z, _np(z_ref)) <= 1e-5
    assert rel_err(attn, _np(attn_ref)) <= 1e-5


# ---------------------------------------------------- (g)

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    monkeypatch.setattr(JA, "_on_tpu", lambda: True)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_plain_k6_forward_at_16_heads_and_577_matches_pallas(interpret,
                                                             dtype, atol):
    # the teacher's K6 shape a frame, [1, 16, 577, 64]: 577 = 4*128 + 65,
    # the TPU pads the queries to 640 and the padded rows must not leak
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(11)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 16, 577, 64)).astype(
        np.float32)).astype(jdt) for _ in range(3))
    scale = 64 ** -0.5
    out, lse, _ = JA._flash_fwd(q, k, v, scale, JA.DEFAULT_BLOCK_Q)
    tq, tk, tv = (torch.from_numpy(_np(x)).to(getattr(torch, dtype))
                  for x in (q, k, v))
    tout, tlse = TA.flash_fwd(tq, tk, tv, scale)
    assert tlse is None and tout.shape == (1, 16, 577, 64)
    assert tout.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tout.float().numpy()[0], _np(out)[:16, :577],
                               rtol=0 if dtype == "bfloat16" else 1e-5,
                               atol=atol)
    _, tlse = TA.flash_fwd(tq, tk, tv, scale, with_lse=True)
    np.testing.assert_allclose(tlse.numpy()[0], _np(lse)[:16, :577, 0],
                               rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 1e-3)
