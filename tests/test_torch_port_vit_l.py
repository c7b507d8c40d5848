"""unite_torch's ViT-L/16 stage-2 and stage-3 configurations against
unite_tpu's, on the CPU.

``bench.py --large2`` finetunes ``vit_large_patch16_224`` (24 blocks of
1024, 16 heads of 64) at 8x224^2, and the stage 3 it feeds self-trains
``adaptation_umt_large_patch16_224`` against ``clip_l14`` at 196^2 (decoders
1024 -> 768, 768-wide text features from an .npy: JAX's text tower is B/16
only). The full-size models are compared by names, shapes, counts and the
optimizer's per-parameter decisions only: the port builds them on the
``meta`` device from the entries' own parsers and build functions, JAX
traces its ``init`` with ``jax.eval_shape``, so nothing full-size is
allocated.

The numbers come from narrow models with ViT-L's 16 heads, held to JAX in
fp32 at the existing gates' tolerances (tests/test_torch_port_finetune.py
and tests/test_torch_port_selftrain.py): loss and grad norm within 1e-5
relative, every parameter within rtol 1e-5 / atol 1e-6 and every update
within 1e-3 of its norm. Stage 3 runs a patch-14 teacher whose grid
matches the student's (28^2 against 32^2, as 196^2 against 224^2) and
whose output width (96) is neither 512 nor the student's (256), with
text features of that width. The chain carries a stage-1 checkpoint with
ViT-L's parameter names (24 blocks, 16 heads) at a narrow width into
stage 2, and its checkpoint into stage 3, bit for bit.
"""

from pathlib import Path
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.config import parse_with_config as jparse
from unite_tpu.engines import finetune as jft
from unite_tpu.engines import selftrain as jst
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.models import clip_text as jtext
from unite_tpu.models import vit as jvit
from unite_tpu.optim import factory as jfactory
from unite_tpu.train import args as jargs
from unite_tpu.train import run_stage1 as jrun1
from unite_tpu.train import run_stage2 as jrun2
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_torch.config import parse_with_config
from unite_torch.engines import finetune as tft
from unite_torch.engines import selftrain as tst
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.models import clip_text as ttext
from unite_torch.models import vit as tvit
from unite_torch.optim import factory as tfactory
from unite_torch.train import run_stage1 as trun1
from unite_torch.train import run_stage2 as trun2
from unite_torch.train import run_stage3 as trun3
from unite_torch.train.args import stage2_parser, stage3_parser
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck
from unite_torch.utils.flax_bridge import (clip_key, flatten,
                                           flax_to_state_dict, student_key)

ROOT = Path(__file__).resolve().parents[1]
# the entries' command lines: the shipped configs with the ViT-L models
STAGE2_ARGV = ["--config", str(ROOT / "configs/stage2_config.yaml"),
               "--model", "vit_large_patch16_224"]
STAGE3_ARGV = ["--config", str(ROOT / "configs/stage3_config.yaml"),
               "--model", "adaptation_umt_large_patch16_224",
               "--clip_teacher", "clip_l14", "--clip_input_resolution", "196",
               "--clip_decoder_embed_dim", "1024", "--clip_output_dim", "768"]


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _stand_ins(shapes):
    """Zero-stride numpy arrays of ``jax.eval_shape``'s shapes: the bridge
    and the optimizer's metadata read them, nothing is allocated."""
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)


def _mapped(shapes, key_fn, patch_size):
    """Port key -> shape of every leaf of a JAX params tree."""
    out = {}
    for path, arr in _paths(_stand_ins(shapes)):
        key, val = key_fn(path, arr, patch_size)
        out[key] = tuple(val.shape)
    return out


def _same_params(module, mapped):
    state = {k: v for k, v in module.state_dict().items()}
    assert all(v.device.type == "meta" for v in state.values())
    params = dict(module.named_parameters())
    assert set(mapped) <= set(state)
    # what the port has beyond JAX's params are its fixed buffers
    assert set(params) <= set(mapped), set(params) - set(mapped)
    for key, shape in mapped.items():
        assert tuple(state[key].shape) == shape, key
    return sum(int(np.prod(s)) for s in mapped.values())


@pytest.fixture(scope="module")
def stage2_vit_l():
    """run_stage2's ViT-L from its parser: the port's on meta, JAX's
    params under eval_shape."""
    args = parse_with_config(stage2_parser(), STAGE2_ARGV)
    jargs_ = jparse(jargs.stage2_parser(), STAGE2_ARGV)
    model = trun2.build_model(args, device="meta")
    jm = jrun2.build_model(jargs_)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 8, 224, 224, 3), jnp.float32))["params"]
    return args, jargs_, model, shapes


def test_stage2_builds_vit_l_as_jax_on_meta(stage2_vit_l):
    args, _, model, shapes = stage2_vit_l
    assert args.frozen_layers == "0,1,2,3,4,5,6" and args.layer_decay == 0.65
    n = _same_params(model, _mapped(shapes, student_key, 16))
    assert n == sum(p.numel() for p in model.parameters())
    assert n > 3e8  # ~304M
    assert model.depth == 24 and len(model.blocks) == 24
    assert model.blocks[0].attn.num_heads == 16
    assert model.pos_embed.shape == (1, 1568, 1024)
    assert model.head.weight.shape == (12, 1024)


def test_stage2_mask_and_layer_decay_over_24_blocks_match_jax(stage2_vit_l):
    # configs/stage2_config.yaml: blocks 0-6 frozen, layer decay 0.65 over
    # 24 blocks (26 layer ids: the embeddings, the blocks, the head)
    args, jargs_, model, shapes = stage2_vit_l
    p = _stand_ins(shapes)
    names = {".".join(k): n for k, n in zip(
        flatten(p), (student_key(path, a, 16)[0] for path, a in _paths(p)))}
    mask = trun2.trainable_mask(args, model)
    jmask = {".".join(k): bool(v) for k, v in
             flatten(jrun2.trainable_mask(jargs_, p)).items()}
    assert mask == {names[k]: v for k, v in jmask.items()}
    assert not any(v for k, v in mask.items()
                   if k.startswith(tuple(f"blocks.{i}." for i in range(7))))
    groups = tfactory.param_group_metadata(
        model.named_parameters(), args.weight_decay,
        trainable=mask.__getitem__, num_layers=model.depth,
        layer_decay=args.layer_decay)
    _, _, jgroups = jfactory.param_group_metadata(
        p, jargs_.weight_decay, num_layers=24, layer_decay=0.65,
        trainable_mask=jrun2.trainable_mask(jargs_, p))
    assert set(groups) == set(jgroups)
    for g, meta in groups.items():
        assert sorted(meta["params"]) == sorted(
            names[x] for x in jgroups[g]["params"]), g
        assert meta["lr_scale"] == jgroups[g]["lr_scale"], g
        assert meta["weight_decay"] == jgroups[g]["weight_decay"], g
    scales = tfactory.layer_decay_scales(0.65, 24)
    assert len(scales) == 26 and scales == jfactory.layer_decay_scales(0.65,
                                                                        24)
    # every trainable layer id of the 24-block model has its group
    live = {int(g.split("_")[1]) for g in groups if g.startswith("layer_")}
    assert live == {0} | set(range(8, 26))


def test_stage3_entry_builds_the_vit_l_models_on_meta():
    parser = stage3_parser()
    args = parse_with_config(parser, STAGE3_ARGV)
    jargs_ = jparse(jargs.stage3_parser(), STAGE3_ARGV)
    assert args.clip_return_layers == [6] and not args.use_cls_token
    assert args.mask_ratio == 0.8
    student = trun1.build_student(args, device="meta")
    teacher = trun1.build_teacher(args, device="meta")
    width = student.encoder.norm.weight.shape[0]
    classifier = trun3.build_classifier(args, width, device="meta")
    assert width == 1024 and classifier.weight.shape == (12, 1024)
    assert teacher.input_resolution == 196 and teacher.patch_size == 14
    assert teacher.proj.shape == (1024, 768)
    assert teacher.positional_embedding.shape == (197, 1024)
    assert student.clip_decoder[0].head.weight.shape == (768, 1024)
    js, jt = jrun1.build_student(jargs_), jrun1.build_teacher(jargs_)
    sshape = jax.eval_shape(
        lambda v: js.init(jax.random.PRNGKey(0), v, None, False),
        jax.ShapeDtypeStruct((1, 8, 224, 224, 3), jnp.float32))["params"]
    tshape = jax.eval_shape(
        jt.init, jax.random.PRNGKey(1),
        jax.ShapeDtypeStruct((1, 1, 196, 196, 3), jnp.float32))["params"]
    assert _same_params(student, _mapped(sshape, student_key, 16)) > 3e8
    assert _same_params(teacher, _mapped(tshape, clip_key, 14)) > 3e8


# ------------------------------------------------------------------ gates

def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def close(a, b, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(a).detach().float()),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def held_to(got: dict, ref: dict, prev: dict) -> dict:
    """Every parameter within rtol 1e-5 / atol 1e-6 of JAX's, every update
    within 1e-3 of its norm; returns copies for the next step."""
    assert set(ref) == set(got)
    for k in ref:
        close(got[k], ref[k], err_msg=k)
        d_got, d_ref = got[k] - prev[k], ref[k] - prev[k]
        assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm() + 1e-9, k
    return {k: v.clone() for k, v in got.items()}


# 16 heads of 16 lanes over 4 frames of 224^2: 784 tokens, the packed route
VIT = dict(img_size=224, patch_size=16, num_classes=12, embed_dim=256,
           depth=2, num_heads=16, all_frames=4, tubelet_size=1,
           init_scale=0.001)
FREEZE = SimpleNamespace(frozen_layers="0", train_head_only=False,
                         freeze_patch_embedding=False)


def test_stage2_step_at_16_heads_matches_jax_over_two_steps():
    jm = jvit.VisionTransformer(**VIT)
    rng = np.random.default_rng(0)
    p = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4, 224, 224, 3)))["params"], 1)
    lr_tab = jsched.cosine_scheduler(5e-4, 1e-5, 1, 3)
    wd_tab = jsched.cosine_scheduler(0.05, 0.05, 1, 3)
    eps = 1e-6  # as tests/test_torch_port_finetune.py's gate
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr_tab, params=p, weight_decay=wd_tab,
        betas=(0.9, 0.999), eps=eps, num_layers=2, layer_decay=0.65,
        trainable_mask=jrun2.trainable_mask(FREEZE, p))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, p), tx)
    jstep = jax.jit(jft.make_finetune_train_step(jm))
    tm = tvit.VisionTransformer(**VIT)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    assert tm.blocks[0].attn.num_heads == 16
    mask = trun2.trainable_mask(FREEZE, tm)
    opt, _ = tfactory.create_optimizer(
        "adamw", lr_tab, tm, weight_decay=wd_tab, betas=(0.9, 0.999),
        eps=eps, trainable=mask.__getitem__, num_layers=tm.depth,
        layer_decay=0.65, device="cpu")
    state = TrainState(tm, opt)
    step = tft.make_finetune_train_step(tm, device="cpu")
    prev = {k: v.clone() for k, v in tm.state_dict().items()}
    for _ in range(2):
        vids = rng.integers(0, 256, (2, 4, 224, 224, 3), dtype=np.uint8)
        labels = rng.integers(0, 12, (2,)).astype(np.int32)
        jstate, jm_ = jstep(jstate, {"videos": jnp.asarray(vids),
                                     "labels": jnp.asarray(labels)},
                            jax.random.PRNGKey(0))
        m = step(state, {"videos": torch.from_numpy(vids),
                         "labels": torch.from_numpy(labels)})
        for k in ("loss", "grad_norm", "class_acc"):
            np.testing.assert_allclose(m[k].item(), float(jm_[k]), rtol=1e-5,
                                       err_msg=k)
        prev = held_to(tm.state_dict(), flax_to_state_dict(
            jax.tree.map(np.asarray, jstate.params)), prev)
    assert state.step == 2


STUDENT = dict(img_size=32, patch_size=16, encoder_embed_dim=256,
               encoder_depth=2, encoder_num_heads=16, num_frames=4,
               tubelet_size=1, clip_decoder_embed_dim=256, clip_output_dim=96,
               clip_return_layers=(1,))
# patch 14 at 28^2: the 2x2 grid of the /16 student at 32^2, as clip_l14's
# 14x14 at 196^2 is ViT-L/16's at 224^2; output 96, neither 512 nor 256
TEACHER = dict(input_resolution=28, patch_size=14, width=192, layers=2,
               heads=12, output_dim=96, return_attn=True, return_index=(1,))
# clip_threshold 0.9 (the config's 0.1): the zero-shot rows of random
# text features are confident and the student's are not, so the selection
# takes rows and the pseudo-label loss trains the student
GEOM = dict(num_patches=16, frames=4, mask_ratio=0.5, nb_classes=12,
            clip_input_resolution=28, clip_threshold=0.9)
ARGS3 = SimpleNamespace(opt="adamw", opt_betas=[0.9, 0.95], opt_eps=1e-6,
                        nb_classes=12, freeze_clip_decoders=False,
                        src_classifier_type="linear")


def test_stage3_step_with_a_patch14_teacher_matches_jax(tmp_path):
    sj = jad.AdaptationVisionTransformer(**STUDENT)
    tj = jclip.CLIPVisionTransformer(**TEACHER)
    cj = fnn.Dense(12, param_dtype=jnp.float32, dtype=jnp.float32)
    sp = perturb(jax.jit(sj.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4, 32, 32, 3)))["params"], 1)
    tp = perturb(jax.jit(tj.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 4, 28, 28, 3)))["params"], 2)
    hp = perturb(cj.init(jax.random.PRNGKey(2),
                         jnp.zeros((1, 256)))["params"], 3)
    sm = tad.AdaptationVisionTransformer(**STUDENT)
    sm.load_state_dict(flax_to_state_dict(sp), strict=True)
    tm = tclip.CLIPVisionTransformer(**TEACHER)
    tm.load_state_dict(flax_to_state_dict(tp, kind="clip", patch_size=14),
                       strict=True)
    cm = trun3.build_classifier(ARGS3, sm.encoder.norm.weight.shape[0],
                                device="cpu")
    cm.load_state_dict({"weight": torch.from_numpy(hp["kernel"].T.copy()),
                        "bias": torch.from_numpy(hp["bias"].copy())})
    model = trun3.combine(sm, cm)

    # the zero-shot teacher from 96-wide text features, on both sides
    feats = tmp_path / "text_features.npy"
    np.save(feats, np.random.default_rng(4).standard_normal(
        (12, 96)).astype(np.float32))
    zs_args = SimpleNamespace(clip_text_features=str(feats),
                              clip_input_resolution=28, nb_classes=12)
    jzs = jtext.build_zero_shot_fn(zs_args, tj, jax.tree.map(jnp.asarray,
                                                             tp))
    tzs = ttext.build_zero_shot_fn(zs_args, tm)

    lr = jsched.cosine_scheduler(5e-4, 2.5e-5, 1, 3, warmup_steps=1,
                                 start_warmup_value=2.5e-4)
    wd = jsched.cosine_scheduler(0.05, 0.2, 1, 3)
    params = {"model": sp, "classifier": hp}
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr, params=params, weight_decay=wd, betas=(0.9, 0.95),
        eps=1e-6, trainable_mask={
            "model": jax.tree.map(lambda _: True, sp),
            "classifier": jax.tree.map(lambda _: False, hp)})
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, params), tx)
    otx, _ = trun3.build_optimizer(ARGS3, model, lr, wd, device="cpu")
    state = TrainState(model, otx)
    jstep = jax.jit(jst.make_selftrain_step(sj, cj, tj, **GEOM))
    step = tst.make_selftrain_step(sm, cm, tm, device="cpu", **GEOM)

    rng = np.random.default_rng(10)

    def vid(b):
        return rng.integers(0, 256, (b, 4, 32, 32, 3), dtype=np.uint8)

    prev = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        batch = {"videos_s": vid(2),
                 "labels_s": rng.integers(0, 12, 2).astype(np.int32),
                 "videos_t": vid(4), "videos_t_aug": vid(4),
                 "labels_t": rng.integers(0, 12, 4).astype(np.int32),
                 "classwise_thresholds": np.zeros(12, np.float32)}
        sim_j = np.asarray(jzs(jnp.asarray(batch["videos_t"])))
        sim_t = tzs(torch.from_numpy(batch["videos_t"]))
        assert sim_t.shape == (4, 12)
        # 100 x cosine before the softmax: fp32 rounding of the features
        # grows a hundredfold in the logits
        close(sim_t, sim_j, rtol=1e-4, atol=1e-7)
        batch["clip_sim"] = sim_j.astype(np.float32)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, tp),
                           {k: jnp.asarray(v) for k, v in batch.items()},
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
        jp = jax.tree.map(np.array, jstate.params)
        ref = {f"model.{k}": v
               for k, v in flax_to_state_dict(jp["model"]).items()}
        ref["classifier.weight"] = torch.from_numpy(
            jp["classifier"]["kernel"].T)
        ref["classifier.bias"] = torch.from_numpy(jp["classifier"]["bias"])
        prev = held_to(model.state_dict(), ref, prev)
    assert 0.0 < float(jm["sel_ratio"]) <= 1.0  # a selection that trains
    assert state.step == 2


# ViT-L's parameter names (24 blocks, 16 heads, taps 18-23) at width 64
NAMES = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=1)
L_NARROW = dict(NAMES, encoder_embed_dim=64, encoder_depth=24,
                encoder_num_heads=16, clip_decoder_embed_dim=64,
                clip_output_dim=48)


def _entry_args(**kw):
    return SimpleNamespace(**dict(
        model_key="model|module", nb_classes=12, delete_head=True,
        input_size=32, patch_size=16, num_frames=4, tubelet_size=1,
        use_mean_pooling=True, use_cls_token=False, clip_decoder_init="",
        src_classifier_init="", eval=False, **kw))


def test_vit_l_chain_carries_every_parameter(tmp_path):
    torch.manual_seed(0)
    s1 = tad.AdaptationVisionTransformer(
        clip_return_layers=(18, 19, 20, 21, 22, 23), **L_NARROW)
    full = trun1.build_student(parse_with_config(
        stage3_parser(), STAGE3_ARGV + ["--clip_return_layers", "18", "19",
                                        "20", "21", "22", "23"]),
        device="meta")
    assert set(s1.state_dict()) == set(full.state_dict())
    ck.save_checkpoint(str(tmp_path / "s1"), 0, s1.state_dict(),
                       optimizer={"count": 3, "moments": {}})

    # stage 2: --finetune the stage-1 checkpoint
    vit = tvit.VisionTransformer(embed_dim=64, depth=24, num_heads=16,
                                 num_classes=12, all_frames=4, img_size=32,
                                 patch_size=16, tubelet_size=1)
    trun2.load_finetune_ckpt(_entry_args(
        finetune=str(tmp_path / "s1" / "checkpoint-latest.pth")), vit)
    enc = {k[len("encoder."):]: v for k, v in s1.state_dict().items()
           if k.startswith("encoder.")}
    got = vit.state_dict()
    carried = [k for k in got if k in enc]
    assert {k for k in got if k.startswith(("blocks.", "patch_embed."))} \
        <= set(carried)
    assert len([k for k in carried if k.startswith("blocks.")]) == 24 * 13
    for k in carried:
        assert torch.equal(got[k], enc[k]), k
    with torch.no_grad():  # a trained head, so that its carry shows
        vit.head.weight.normal_()
        vit.head.bias.normal_()
    ck.save_checkpoint(str(tmp_path / "s2"), 0, vit.state_dict(),
                       optimizer={"count": 3, "moments": {}},
                       tags=("best",))

    # stage 3: --student_init the stage-2 checkpoint-best
    path = str(tmp_path / "s2" / "checkpoint-best.pth")
    torch.manual_seed(1)
    s3 = tad.AdaptationVisionTransformer(clip_return_layers=(6,), **L_NARROW)
    args = _entry_args(student_init=path)
    trun1.load_student(args, s3)
    classifier = trun3.build_classifier(
        SimpleNamespace(nb_classes=12, src_classifier_type="linear"),
        s3.encoder.norm.weight.shape[0], device="cpu")
    assert trun3.load_classifier_head(args, classifier) == path
    src = vit.state_dict()
    own = s3.encoder.state_dict()
    carried = [k for k in src if k in own]
    assert {k for k in own if k.startswith(("blocks.", "patch_embed."))} \
        <= set(carried)
    for k in carried:
        assert torch.equal(own[k], src[k]), k
    assert torch.equal(classifier.weight, src["head.weight"])
    assert torch.equal(classifier.bias, src["head.bias"])
