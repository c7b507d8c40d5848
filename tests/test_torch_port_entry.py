"""unite_torch's stage-1 entry and its data path against unite_tpu, on the
CPU, with tiny models.

* The CLI schema and config resolution give the JAX package's namespace for
  every shipped config, and ``chip_smoke.py``'s command line equals
  configs/stage1_config.yaml plus stage1.sh.
* Pretraining items and loader batches equal ``unite_tpu.data``'s on the
  synthetic reader, in the same order, bitwise on the PIL path and on the
  uint8 ``device_normalize`` path (both resize with cv2 INTER_LINEAR), with
  equal crop boxes and flips.
* ``run_stage1.main`` over two epochs (tube masks from the data path, drop
  path 0, fp32) writes the per-epoch train loss that the JAX step gives
  over the same batches from the same weights (rtol 1e-5, fp32 summation
  order), and the JAX entry's own, run from the same weight files.
* A run preempted mid-epoch and auto-resumed ends bitwise where an
  uninterrupted run ends (parameters, AdamW moments and counts).
* Key surgery, checkpoints and the reader and loader details.
"""

import json
import os
import re
import shlex
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unite_tpu import config as jconfig
from unite_tpu.data import loader as jloader
from unite_tpu.data import sharding as jsharding
from unite_tpu.data import video_reader as jreader
from unite_tpu.data.build import build_pretraining_dataset as jbuild
from unite_tpu.engines.pretrain_umt import (
    make_pretrain_train_step as jax_step_builder,
)
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.optim import factory as jfactory
from unite_tpu.train import args as jargs
from unite_tpu.train.run_stage1 import unused_block_mask as junused
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import torch_import as jti
from unite_torch import config as tconfig
from unite_torch.data import loader as tloader
from unite_torch.data import sharding as tsharding
from unite_torch.data import video_reader as treader
from unite_torch.data.build import build_pretraining_dataset as tbuild
from unite_torch.models.adaptation import AdaptationVisionTransformer
from unite_torch.models.clip import CLIPVisionTransformer
from unite_torch.train import args as targs
from unite_torch.train import common
from unite_torch.train import run_stage1
from unite_torch.utils import checkpoint as ck
from unite_torch.utils import torch_import as tti
from unite_torch.utils.flax_bridge import flax_to_state_dict
from unite_torch.utils.registry import _MODEL_REGISTRY, register_model

ROOT = Path(__file__).resolve().parents[1]
TINY_STUDENT = dict(img_size=32, patch_size=8, encoder_embed_dim=32,
                    encoder_depth=2, encoder_num_heads=2,
                    clip_decoder_embed_dim=32, clip_output_dim=16)
TINY_TEACHER = dict(patch_size=8, width=32, layers=2, heads=2, output_dim=16)

if "adaptation_test_tiny" not in _MODEL_REGISTRY:

    @register_model
    def adaptation_test_tiny(**kwargs):
        for k in TINY_STUDENT:
            kwargs.pop(k, None)
        return AdaptationVisionTransformer(**TINY_STUDENT, **kwargs)

    @register_model
    def clip_test_tiny(**kwargs):
        return CLIPVisionTransformer(**TINY_TEACHER, **kwargs)

    @register_model
    def clip_b16_test_tiny(**kwargs):  # the importer reads "b16": patch 16
        return CLIPVisionTransformer(**dict(TINY_TEACHER, patch_size=16),
                                     **kwargs)


def _ann(tmp_path, name, n):
    p = tmp_path / name
    p.write_text("".join(f"video_{name}_{i:03d}.mp4,{i % 3}\n"
                         for i in range(n)))
    return str(p)


# ------------------------------------------------------------- the schema


@pytest.mark.parametrize("stage,config,extra", [
    ("stage1", "stage1_config.yaml", []),
    ("stage2", "stage2_config.yaml", []),
    ("stage3", "stage3_config.yaml", []),
    ("stage1", "stage1_config.yaml", ["--dataset", "hmdb-arid"])])
def test_schema_and_configs_resolve_as_in_jax(stage, config, extra):
    argv = ["--config", str(ROOT / "configs" / config),
            "--dataset_mappings", str(ROOT / "configs/dataset_mappings.yaml"),
            "--lr", "3e-4"] + extra  # a flag wins over the YAML
    parser = f"{stage}_parser"
    got = vars(tconfig.parse_with_config(getattr(targs, parser)(), argv))
    ref = vars(jconfig.parse_with_config(getattr(jargs, parser)(), argv))
    assert got == ref
    assert got["lr"] == 3e-4
    assert vars(getattr(targs, parser)().parse_args([])) == vars(
        getattr(jargs, parser)().parse_args([]))


def test_chip_smoke_command_line_is_config_plus_launcher():
    text = (ROOT / "stage1.sh").read_text()
    flags = re.findall(r"^\s*(--\w+)(?: (\S+))?\s*\\\s*$", text, re.M)
    skip = {"--config", "--dataset", "--output_dir", "--clip_decoder_init",
            "--student_init"}
    launcher = [x for f, v in flags if f not in skip
                for x in ([f, v] if v else [f])]
    assert "--batch_size" in launcher and "--clip_loss_data" in launcher
    ref = jconfig.parse_with_config(jargs.stage1_parser(), [
        "--config", str(ROOT / "configs/stage1_config.yaml")] + launcher)
    got = tconfig.parse_with_config(targs.stage1_parser(),
                                    chip_smoke.STAGE1_ARGS)
    assert vars(got) == dict(vars(ref), config=None)
    # stage 2: the launcher's command as the shell runs it at its default
    # EPOCHS=50 (warmup EPOCHS / 5)
    text = (ROOT / "stage2.sh").read_text()
    assert "EPOCHS=${EPOCHS:-50}" in text
    cmd = text[text.index("python -m"):].replace(
        "$((EPOCHS / 5))", "10").replace('"$EPOCHS"', "50")
    words = shlex.split(cmd.replace("\\\n", " "))[3:]
    assert words[-1] == "$@"
    pairs = list(zip(words[:-1:2], words[1:-1:2]))
    assert all(f.startswith("--") for f, _ in pairs)
    launcher = [x for f, v in pairs if f not in (
        "--config", "--dataset", "--output_dir", "--finetune") for x in (f, v)]
    assert launcher[:2] == ["--frozen_layers", ""] and "--eval_freq" in launcher
    ref = jconfig.parse_with_config(jargs.stage2_parser(), [
        "--config", str(ROOT / "configs/stage2_config.yaml")] + launcher)
    got = tconfig.parse_with_config(targs.stage2_parser(),
                                    chip_smoke.STAGE2_ARGS)
    assert vars(got) == dict(vars(ref), config=None)


def test_dump_config_without_yaml(tmp_path, monkeypatch):
    import sys

    args = targs.stage1_parser().parse_args([])
    monkeypatch.setitem(sys.modules, "yaml", None)
    tconfig.dump_config(args, str(tmp_path))
    saved = json.loads((tmp_path / "config.yaml").read_text())
    assert saved["mask_ratio"] == 0.8 and saved["opt_betas"] is None


# ----------------------------------------------------------- the data path


def _data_args(tmp_path, **kw):
    args = targs.stage1_parser().parse_args([])
    args.__dict__.update(num_frames=4, num_segments=4, input_size=64,
                         patch_size=16, tubelet_size=1, mask_type="tube",
                         mask_ratio=0.75, split=",", seed=3, flip=True)
    args.__dict__.update(kw)
    return args


@pytest.mark.parametrize("device_normalize", [False, True])
def test_pretrain_items_match_jax(tmp_path, device_normalize):
    args = _data_args(tmp_path, device_normalize=device_normalize)
    anno = _ann(tmp_path, "a.csv", 6)
    ds = tbuild(args, anno, reader=treader.SyntheticVideoReader(256, 320))
    jds = jbuild(args, anno, reader=jreader.SyntheticVideoReader(256, 320))
    boxes = {}
    for name, d in (("port", ds), ("jax", jds)):
        sample = d.crop._sample_crop
        d.crop._sample_crop = lambda *a, _s=sample, _n=name: (
            boxes.setdefault(_n, []).append(_s(*a)), boxes[_n][-1])[1]
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            (v, m, lab), (jv, jm, jlab) = ds[i], jds[i]
            assert v.dtype == jv.dtype and v.shape == jv.shape == (
                4, 64, 64, 3)
            np.testing.assert_array_equal(m, jm)
            assert lab == jlab
            np.testing.assert_array_equal(v, jv)
    assert boxes["port"] == boxes["jax"] and len(boxes["port"]) == 12


def test_loader_batches_match_jax(tmp_path):
    args = _data_args(tmp_path)
    anno = _ann(tmp_path, "b.csv", 10)
    batches = {}
    for name, build, reader, sh, ld in (
            ("port", tbuild, treader, tsharding, tloader),
            ("jax", jbuild, jreader, jsharding, jloader)):
        ds = build(args, anno, reader=reader.SyntheticVideoReader(256, 320))
        sampler = sh.ShardedSampler(len(ds), 1, 0, shuffle=True, seed=7,
                                    repetitions=2)
        loader = ld.DataLoader(ds, 4, sampler=sampler, num_workers=2,
                               drop_last=True)
        out = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            out += list(loader)
        loader.skip_next_batches(2)
        out += list(ld.echo_batches(loader, 2, skip_echoes=1))
        stream = ld.cycle(loader, skip_batches=7)
        out += [next(stream) for _ in range(3)]
        batches[name] = out
    assert len(batches["port"]) == 5 + 5 + 5 + 3
    for got, ref in zip(batches["port"], batches["jax"]):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tsharding.repetitions_to_match(3, 10) == \
        jsharding.repetitions_to_match(3, 10) == 4


def test_loader_process_workers_equal_threads_and_reset_sigterm(tmp_path):
    args = _data_args(tmp_path)
    ds = tbuild(args, _ann(tmp_path, "c.csv", 8),
                reader=treader.SyntheticVideoReader(256, 320))
    runs = []
    for mode in ("thread", "process"):
        loader = tloader.DataLoader(ds, 4, num_workers=2, worker_mode=mode)
        runs.append(list(loader))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a[0], b[0])
    # a worker starts with the default SIGTERM disposition whatever the
    # parent installed (a PreemptionGuard's handler would swallow the pool's
    # terminate())
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        tloader._init_worker(ds, tloader.default_collate)
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    finally:
        signal.signal(signal.SIGTERM, prev)
        signal.signal(signal.SIGINT, signal.default_int_handler)


def test_readers(monkeypatch):
    ref = jreader.SyntheticVideoReader(64, 80)
    got = treader.SyntheticVideoReader(64, 80)
    for path in ("a.mp4", "b/c.mp4"):
        assert got.num_frames(path) == ref.num_frames(path)
        np.testing.assert_array_equal(got.get_batch(path, [0, 5, 3]),
                                      ref.get_batch(path, [0, 5, 3]))
    # the native decoder first, then OpenCV, as JAX's default_reader
    assert isinstance(treader.default_reader(), treader.NativeVideoReader)
    assert isinstance(jreader.default_reader(), jreader.NativeVideoReader)
    monkeypatch.setattr(treader.NativeVideoReader, "available",
                        classmethod(lambda cls: False))
    assert isinstance(treader.default_reader(), treader.CV2VideoReader)


# -------------------------------------------------------------- the entry


def _entry_args(tmp_path, out, epochs=2, **kw):
    args = tconfig.parse_with_config(targs.stage1_parser(), [])
    args.__dict__.update(
        model="adaptation_test_tiny", clip_teacher="clip_test_tiny",
        clip_return_layers=[0, 1], clip_input_resolution=32,
        ann_file_train=_ann(tmp_path, "s1.csv", 16),
        ann_file_train_target=_ann(tmp_path, "s1t.csv", 8), split=",",
        synthetic_data=True, input_size=32, patch_size=8, num_frames=2,
        num_segments=2, tubelet_size=1, mask_ratio=0.5, batch_size=4,
        epochs=epochs, warmup_epochs=1, num_workers=2, log_freq=1,
        output_dir=str(out), overwrite="allow", seed=5,
        compute_dtype="float32", opt_betas=[0.9, 0.95], opt_eps=1e-6)
    args.__dict__.update(kw)
    return args


def _epoch_losses(out):
    return {r["epoch"]: r["train_loss"] for r in map(
        json.loads, (Path(out) / "log.txt").read_text().splitlines())}


def _capture_steps(monkeypatch):
    """Wrap the entry's step builder: the weights the step starts from, and
    every batch and metric it sees."""
    seen = {"batches": [], "losses": []}
    build = run_stage1.make_pretrain_train_step

    def capture(student, teacher, **kw):
        seen["student"] = {k: v.clone() for k, v in
                           student.state_dict().items()}
        seen["teacher"] = {k: v.clone() for k, v in
                           teacher.state_dict().items()}
        seen["geom"] = kw
        step = build(student, teacher, **kw)

        def wrapped(state, batch, gen=None):
            seen["batches"].append({k: v.clone() for k, v in batch.items()})
            m = step(state, batch, gen)
            seen["losses"].append(m["loss"].item())
            return m

        return wrapped

    monkeypatch.setattr(run_stage1, "make_pretrain_train_step", capture)
    return seen


def _jax_models(seen):
    """JAX student and teacher with the entry's starting weights, through
    unite_tpu's own importer."""
    sj = jad.AdaptationVisionTransformer(
        num_frames=2, tubelet_size=1, clip_return_layers=(0, 1),
        **TINY_STUDENT)
    tj = jclip.CLIPVisionTransformer(input_resolution=32, return_attn=True,
                                     return_index=(0, 1), **TINY_TEACHER)
    x = jnp.zeros((1, 2, 32, 32, 3))
    sp = sj.init(jax.random.PRNGKey(0), x, jnp.zeros((1, 8), jnp.int32),
                 False)["params"]
    sp, missing, _ = jti.merge_params(
        sp, jti.state_to_flax_params(seen["student"]))
    assert not missing
    tp = tj.init(jax.random.PRNGKey(1), x)["params"]
    tp, missing, _ = jti.merge_params(tp, jti.clip_state_to_flax_params(
        seen["teacher"], input_resolution=32, patch_size=8))
    assert not missing
    return sj, tj, sp, tp


def test_entry_matches_the_jax_step_over_the_same_batches(tmp_path,
                                                         monkeypatch):
    out = tmp_path / "run"
    args = _entry_args(tmp_path, out, mask_type="tube", drop_path=0.0)
    seen = _capture_steps(monkeypatch)
    run_stage1.main(args, device="cpu")
    losses = _epoch_losses(out)
    assert set(losses) == {0, 1} and len(seen["batches"]) == 8
    b = seen["batches"][0]
    assert b["videos"].shape == (8, 2, 32, 32, 3) and b["vis_idx"].shape == (
        8, 16) and b["src_mask"].tolist() == [1.0] * 4 + [0.0] * 4

    sj, tj, sp, tp = _jax_models(seen)
    lr_tab, wd_tab, _ = common.lr_tables(args, 4)
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr_tab, params=sp, weight_decay=wd_tab,
        betas=(0.9, 0.95), eps=1e-6, trainable_mask=junused(sp, 1))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, sp), tx)
    geom = {k: v for k, v in seen["geom"].items() if k != "device"}
    jstep = jax.jit(jax_step_builder(sj, tj, **geom))
    jlosses = []
    for batch in seen["batches"]:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, tp),
                          {k: jnp.asarray(v.numpy()) for k, v in
                           batch.items()}, jax.random.PRNGKey(0))
        jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(seen["losses"], jlosses, rtol=1e-5)
    for epoch in (0, 1):
        np.testing.assert_allclose(losses[epoch],
                                   np.mean(jlosses[4 * epoch:4 * epoch + 4]),
                                   rtol=1e-5)


def test_entry_matches_the_jax_entry(tmp_path, monkeypatch):
    # entry against entry, from the same weight files (the JAX entry on 8
    # fake devices takes a batch of 1 a device, 8 in all)
    from unite_tpu.train.run_stage1 import main as jmain

    import tests.test_entry_resume  # noqa: F401 (registers the JAX tiny models)

    from unite_tpu.utils.registry import _MODEL_REGISTRY as JREG
    from unite_tpu.utils.registry import register_model as jregister

    if "clip_b16_test_tiny" not in JREG:
        @jregister
        def clip_b16_test_tiny(**kwargs):  # patch 16 as the importer reads
            return jclip.CLIPVisionTransformer(
                input_resolution=kwargs["input_resolution"], return_attn=True,
                return_index=kwargs["return_index"],
                dtype=kwargs.get("dtype", jnp.float32),
                **dict(TINY_TEACHER, patch_size=16))

    # a teacher at 64^2 in patches of 16: the student's 4x4 grid
    kw = dict(mask_type="tube", drop_path=0.0,
              clip_teacher="clip_b16_test_tiny", clip_input_resolution=64)
    out = tmp_path / "port"
    args = _entry_args(tmp_path, out, batch_size=8, **kw)
    seen = _capture_steps(monkeypatch)
    run_stage1.main(args, device="cpu")
    init = tmp_path / "init"
    init.mkdir()
    enc = {k[len("encoder."):]: v for k, v in seen["student"].items()
           if k.startswith("encoder.")}
    dec = {k: v for k, v in seen["student"].items()
           if k.startswith("clip_decoder.")}
    torch.save({"model": enc}, init / "student.pth")
    torch.save({"model": dec}, init / "decoder.pth")
    torch.save({"model": seen["teacher"]}, init / "clip.pth")
    jargs_ = jconfig.parse_with_config(jargs.stage1_parser(), [])
    jargs_.__dict__.update(vars(_entry_args(tmp_path, tmp_path / "jax",
                                            batch_size=1, **kw)))
    jargs_.__dict__.update(student_init=str(init / "student.pth"),
                           clip_decoder_init=str(init / "decoder.pth"),
                           clip_init=str(init / "clip.pth"),
                           worker_mode="thread")
    jmain(jargs_)
    got, ref = _epoch_losses(out), _epoch_losses(tmp_path / "jax")
    for epoch in (0, 1):
        np.testing.assert_allclose(got[epoch], ref[epoch], rtol=1e-5)


def test_preempted_run_resumes_bitwise(tmp_path):
    # attention masks and drop path: the step's draws must follow the step
    # counter across the restart
    kw = dict(mask_type="attention", drop_path=0.1, checkpoints_enabled=True,
              auto_resume=True)
    run_stage1.main(_entry_args(tmp_path, tmp_path / "a", **kw), device="cpu")
    run_stage1.main(_entry_args(tmp_path, tmp_path / "b",
                                stop_after_steps=6, **kw), device="cpu")
    mid = ck.load_checkpoint(str(tmp_path / "b" / "checkpoint-latest.pth"))
    assert mid["epoch"] == 1 and mid["extra"] == {"epoch_step": 2, "step": 6}
    run_stage1.main(_entry_args(tmp_path, tmp_path / "b", **kw), device="cpu")
    a = ck.load_checkpoint(str(tmp_path / "a" / "checkpoint-latest.pth"))
    b = ck.load_checkpoint(str(tmp_path / "b" / "checkpoint-latest.pth"))
    assert a["epoch"] == b["epoch"] == 1 and a["extra"] == b["extra"] == {
        "step": 8}
    assert set(a["model"]) == set(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 8
    moments = a["optimizer"]["moments"]
    assert set(moments) == set(b["optimizer"]["moments"]) and moments
    for name, mom in moments.items():
        for k in ("mu", "nu"):
            assert torch.equal(mom[k], b["optimizer"]["moments"][name][k])
    assert _epoch_losses(tmp_path / "a")[0] == _epoch_losses(tmp_path / "b")[0]


def test_entry_refuses_what_it_does_not_have(tmp_path, monkeypatch):
    # --mu_dtype and --use_checkpoint are ported (tests/
    # test_torch_port_recipe.py holds them to the JAX entry)
    # the layouts run under torchrun (tests/test_torch_port_scaleout*.py);
    # one process cannot hold a tensor-parallel group of 2, and a world
    # without ranks is no launch
    with pytest.raises(ValueError, match="must divide the local world"):
        run_stage1.main(_entry_args(tmp_path, tmp_path / "r", tp=2),
                        device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="launch the entry with torchrun"):
        run_stage1.main(_entry_args(tmp_path, tmp_path / "r"), device="cpu")


# ------------------------------------------------ key surgery, checkpoints


def test_key_surgery_matches_jax():
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    # temporal 8 -> 4 frames and spatial 14 -> 7, with and without CLS
    for extra in (0, 1):
        state = {"encoder.pos_embed": rand(1, extra + 8 * 196, 24),
                 "backbone.x": rand(3)}
        args = dict(num_patches=4 * 49, num_extra_tokens=extra, new_frames=4,
                    tubelet_size=1, key="encoder.pos_embed")
        got = tti.interpolate_pos_embed(dict(state), **args)
        ref = jti.interpolate_pos_embed(dict(state), **args)
        torch.testing.assert_close(got["encoder.pos_embed"],
                                   ref["encoder.pos_embed"], rtol=0, atol=0)
        assert got["encoder.pos_embed"].shape == (1, extra + 4 * 49, 24)
    w2d = rand(24, 3, 16, 16)
    for center in (True, False):
        torch.testing.assert_close(tti.inflate_conv_weight(w2d, 3, center),
                                   jti.inflate_conv_weight(w2d, 3, center),
                                   rtol=0, atol=0)
    clip = {"positional_embedding": rand(197, 24), "conv1.weight": w2d}
    torch.testing.assert_close(
        tti.interpolate_clip_pos_embed(clip, 112, 16)["positional_embedding"],
        jti.interpolate_clip_pos_embed(clip, 112, 16)["positional_embedding"],
        rtol=0, atol=0)
    state = {"backbone.blocks.0.w": rand(2), "head.b": rand(2)}
    assert tti.strip_prefixes(state) == jti.strip_prefixes(state)
    assert tti.wrap_encoder_prefix(state) == jti.wrap_encoder_prefix(state)


def test_weight_import_matches_jax(tmp_path):
    # published-style files: a bare encoder, its decoders, and an OpenAI
    # CLIP visual tower with a 2-D patch conv at another resolution; the
    # port's models take what unite_tpu's importer gives its models
    torch.manual_seed(0)
    src = run_stage1.create_model("adaptation_test_tiny", device="cpu",
                                  num_frames=4, tubelet_size=1,
                                  clip_return_layers=(0, 1))
    sd = src.state_dict()
    torch.save({"model": {k[8:]: v for k, v in sd.items()
                          if k.startswith("encoder.")}}, tmp_path / "s.pth")
    torch.save({"module": {k: v for k, v in sd.items()
                           if k.startswith("clip_decoder.")}},
               tmp_path / "d.pth")
    teacher = run_stage1.create_model("clip_b16_test_tiny", device="cpu")
    clip = {k: v for k, v in teacher.state_dict().items()}
    clip["conv1.weight"] = clip["conv1.weight"][:, :, 0]
    clip["positional_embedding"] = torch.randn(26, 32)  # 5x5 grid + CLS
    clip = {k.replace("transformer.", ""): v for k, v in clip.items()}
    torch.save({"state_dict": clip}, tmp_path / "c.pth")
    args = targs.stage1_parser().parse_args([])
    args.__dict__.update(
        model="adaptation_test_tiny", clip_teacher="clip_b16_test_tiny",
        input_size=32, patch_size=8, num_frames=2, tubelet_size=1,
        clip_input_resolution=32, clip_return_layers=[0, 1],
        student_init=str(tmp_path / "s.pth"),
        clip_decoder_init=str(tmp_path / "d.pth"),
        clip_init=str(tmp_path / "c.pth"), compute_dtype="float32")
    student = run_stage1.build_student(args, "cpu")
    run_stage1.load_student(args, student)
    t = run_stage1.build_teacher(args, "cpu")
    run_stage1.load_clip_teacher(args, t)

    from unite_tpu.train import run_stage1 as jrun

    sj = jad.AdaptationVisionTransformer(
        num_frames=2, tubelet_size=1, clip_return_layers=(0, 1),
        **TINY_STUDENT)
    x = jnp.zeros((1, 2, 32, 32, 3))
    sp = jrun.load_student(args, sj.init(
        jax.random.PRNGKey(0), x, jnp.zeros((1, 8), jnp.int32),
        False)["params"])
    ref = flax_to_state_dict(sp, patch_size=8)
    got = dict(student.named_parameters())
    assert set(ref) == set(got)
    for k in ref:
        torch.testing.assert_close(got[k].detach(), ref[k], rtol=0, atol=0)
    tj = jclip.CLIPVisionTransformer(
        input_resolution=32, return_attn=True, return_index=(0, 1),
        **dict(TINY_TEACHER, patch_size=16))
    tp = jrun.load_clip_teacher_params(args, tj, x)
    ref = flax_to_state_dict(tp, kind="clip", patch_size=16)
    got = dict(t.named_parameters())
    assert set(ref) == set(got)
    for k in ref:
        torch.testing.assert_close(got[k].detach(), ref[k], rtol=1e-6,
                                   atol=1e-6)


def test_checkpoint_tags_order_and_async_errors(tmp_path):
    out = str(tmp_path)
    assert ck.find_resume_checkpoint(out) is None
    ck.save_checkpoint(out, 3, {"w": torch.ones(2)}, tags=(3, 7))
    assert ck.find_resume_checkpoint(out).endswith("checkpoint-7.pth")
    ck.save_checkpoint(out, 4, {"w": torch.zeros(2)}, tags=("best",))
    assert ck.find_resume_checkpoint(out).endswith("checkpoint-best.pth")
    ck.save_checkpoint(out, 5, {"w": torch.zeros(2)}, extra={"epoch_step": 2})
    payload = ck.auto_load_model(out)
    assert payload["epoch"] == 5 and payload["extra"] == {"epoch_step": 2}
    assert common.resume_position(payload) == (5, 2)
    assert common.resume_position({"epoch": 5}) == (6, 0)
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="data_echo"):
        common.check_echo_resume({"extra": {"epoch_step": 2},
                                  "args": {"data_echo": 2}}, 1)

    class Broken:  # a state whose snapshot fails in the writer
        model = torch.nn.Linear(2, 2)
        optimizer = type("O", (), {"count": 0, "every_k": 1, "state": {}})()
        ema_params = None
        step = 0

    io = ck.AsyncCheckpointer()
    io.save_train_state(str(tmp_path / "no" / "\0"), 0, Broken())
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        io.wait()
