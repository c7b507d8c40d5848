"""unite_torch's stage-2 entry (``run_stage2.main``) against unite_tpu's, on
the CPU, with tiny models in fp32.

* The pieces: the lr / wd tables (cosine, constant, step; with and without
  the scaling rule) and ``step_scheduler``; ``surgery_head`` with and
  without a label map; gradient accumulation (``wrap_update_freq`` with a
  clip, against ``optax.MultiSteps`` and the JAX TrainState's EMA gating);
  ``run_validation`` and ``run_final_test`` on the same probabilities;
  ``load_finetune_ckpt`` on published-layout weights and on the port's own
  stage-1 and stage-2 checkpoints.
* Entry against entry: ``run_stage2.main(device="cpu")`` at batch 8 on one
  device against JAX's ``run_stage2.main`` on 8 fake CPU devices at 1 a
  device, ``vit_test_tiny`` from the same weight file, drop path 0: the
  per-epoch train loss, the validation acc1 / acc5 / ECE / loss and the
  merged test accuracies agree to rtol 1e-5 (fp32 summation order), with
  gradient accumulation and a clip, the LP-FT switch with EMA,
  ``--reset_train_dataset``, ``--eval`` and ``--finetune`` from a stage-1
  checkpoint of the port.
* A run preempted mid-epoch (also mid accumulation window) or at an epoch
  boundary and auto-resumed ends bit for bit where an uninterrupted run
  ends.
"""

import argparse
import contextlib
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_entry_resume as ter  # registers the JAX tiny models
from unite_tpu.data import datasets as jds
from unite_tpu.data import loader as jloader
from unite_tpu.data import video_reader as jreader
from unite_tpu.engines import finetune as jft
from unite_tpu.models import vit as jvit
from unite_tpu.optim import factory as jfactory
from unite_tpu.parallel import mesh as pmesh
from unite_tpu.train import common as jcommon
from unite_tpu.train import run_stage2 as jrun2
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_tpu.utils import torch_import as jti
from unite_torch.data import datasets as tds
from unite_torch.data import loader as tloader
from unite_torch.data import video_reader as treader
from unite_torch.models.adaptation import AdaptationVisionTransformer
from unite_torch.models.vit import VisionTransformer
from unite_torch.optim import factory as tfactory
from unite_torch.train import common
from unite_torch.train import run_stage2
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck
from unite_torch.utils import schedules as tsched
from unite_torch.utils import torch_import as tti
from unite_torch.utils.flax_bridge import flax_to_state_dict
from unite_torch.utils.registry import _MODEL_REGISTRY, register_model

TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2, qkv_bias=True, norm_eps=1e-6)

if "vit_test_tiny" not in _MODEL_REGISTRY:

    @register_model
    def vit_test_tiny(**kwargs):  # unite_tpu's (tests/test_entry_resume.py)
        return VisionTransformer(**TINY, **kwargs)


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="cosine"),
    dict(lr_schedule="cosine", warmup_steps=3),
    dict(lr_schedule="constant"),
    dict(lr_schedule="constant", warmup_epochs=0),
    dict(lr_schedule="step", lr_step_epochs=[1, 3], step_fraction=0.5),
    dict(lr_schedule="step", lr_step_epochs=[2], warmup_epochs=0,
         warmup_steps=2, weight_decay_end=0.01)])
@pytest.mark.parametrize("scale_rule", [False, True])
def test_lr_tables_match_jax(kw, scale_rule):
    # the JAX package multiplies --batch_size by its 8 fake devices
    base = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-6, epochs=4,
                warmup_epochs=1, warmup_steps=-1, weight_decay=0.05,
                weight_decay_end=None, tp=1, step_fraction=0.1,
                lr_step_epochs=None)
    base.update(kw)
    got = common.lr_tables(SimpleNamespace(batch_size=8, **base), 5, 2,
                           scale_rule=scale_rule)
    ref = jcommon.lr_tables(SimpleNamespace(batch_size=1, **base), 5, 2,
                            scale_rule=scale_rule)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g, r)
    assert got[2] == ref[2] and len(got[0]) == 20


@pytest.mark.parametrize("kw", [
    dict(), dict(steps=[2, 3], step_fraction=[0.5, 0.1]),
    dict(steps=[1], step_fraction=0.2, warmup_epochs=2),
    dict(warmup_steps=5, start_warmup_value=1e-4)])
def test_step_scheduler_matches_jax(kw):
    got = tsched.step_scheduler(0.1, epochs=4, niter_per_ep=3, **kw)
    ref = jsched.step_scheduler(0.1, epochs=4, niter_per_ep=3, **kw)
    np.testing.assert_array_equal(got, ref)


def test_lr_tables_refuse_an_unknown_family():
    args = SimpleNamespace(batch_size=8, lr=1e-3, min_lr=0.0, warmup_lr=0.0,
                           lr_schedule="poly")
    with pytest.raises(NotImplementedError, match="cosine, constant"):
        common.lr_tables(args, 4)
    args.lr_schedule = "step"
    args.lr_step_epochs = None
    with pytest.raises(ValueError, match="lr_step_epochs"):
        common.lr_tables(args, 4)


# ------------------------------------------------------- head surgery


@pytest.mark.parametrize("rows,nb,delete,label_map", [
    (710, 400, False, None), (710, 600, False, True), (710, 700, False, False),
    (710, 12, True, None), (12, 12, False, None)])
def test_surgery_head_matches_jax(tmp_path, rows, nb, delete, label_map):
    rng = np.random.default_rng(rows + nb)
    state = {"head.weight": torch.from_numpy(
                 rng.standard_normal((rows, 8)).astype(np.float32)),
             "head.bias": torch.from_numpy(
                 rng.standard_normal(rows).astype(np.float32)),
             "blocks.0.w": torch.ones(3)}
    path = None
    if label_map is not None:
        path = str(tmp_path / "map.json")
        if label_map:
            Path(path).write_text(json.dumps(
                rng.permutation(rows)[:nb].tolist()))
    absent = (pytest.warns(UserWarning, match="label map")
              if label_map is False else contextlib.nullcontext())
    with absent:
        got = tti.surgery_head(dict(state), nb, delete, label_map_path=path)
    ref = jti.surgery_head(dict(state), nb, delete, label_map_path=path)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], torch.as_tensor(ref[k])), k


# ------------------------------------------------ gradient accumulation


@pytest.mark.parametrize("k,clip", [(2, 0.5), (2, None), (3, 0.05)])
def test_wrap_update_freq_matches_optax_multisteps(k, clip):
    rng = np.random.default_rng(k)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    b0 = rng.standard_normal(3).astype(np.float32)
    module = torch.nn.Linear(4, 3)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w0.T.copy()))
        module.bias.copy_(torch.from_numpy(b0))
    lr_tab = np.linspace(1e-2, 1e-3, 8)
    wd_tab = np.full(8, 0.05)
    tx, _ = tfactory.create_optimizer("adamw", lr_tab, module,
                                      weight_decay=wd_tab, eps=1e-6,
                                      device="cpu")
    state = TrainState(module, common.wrap_update_freq(tx, k, clip),
                       ema_decay=0.9)
    params = {"kernel": jnp.asarray(w0), "bias": jnp.asarray(b0)}
    jtx, _ = jfactory.create_optimizer("adamw", lr=lr_tab, params=params,
                                       weight_decay=wd_tab, eps=1e-6)
    jstate = JaxTrainState.create(params, jcommon.wrap_update_freq(jtx, k,
                                                                   clip),
                                  ema_decay=0.9)
    for i in range(3 * k + 1):
        gw = (rng.standard_normal((4, 3)) * (i + 1) * 0.3).astype(np.float32)
        gb = (rng.standard_normal(3) * 0.3).astype(np.float32)
        module.weight.grad = torch.from_numpy(gw.T.copy())
        module.bias.grad = torch.from_numpy(gb)
        state.apply_gradients(ema_decay=0.9)
        jstate = jstate.apply_gradients(
            {"kernel": jnp.asarray(gw), "bias": jnp.asarray(gb)},
            ema_decay=0.9)
        assert state.optimizer.emitted == ((i + 1) % k == 0)
        for got, ref in ((module.weight.detach().T, jstate.params["kernel"]),
                         (module.bias.detach(), jstate.params["bias"]),
                         (state.ema_params["weight"].T,
                          jstate.ema_params["kernel"]),
                         (state.ema_params["bias"], jstate.ema_params["bias"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-7)
    assert state.step == int(jstate.step) == 3 * k + 1
    assert tx.count == 3


# ------------------------------------------ validation and the final test


W_PROBE = np.random.default_rng(21).standard_normal((3, 5)).astype(
    np.float32)


def _jax_probe(state, batch):
    x = jnp.mean(batch["videos"].astype(jnp.float32), axis=(1, 2, 3))
    return {"probs": jax.nn.softmax(x @ jnp.asarray(W_PROBE), axis=-1)}


def _port_probe(state, batch):
    x = batch["videos"].float().mean(dim=(1, 2, 3))
    return {"probs": torch.softmax(x @ torch.from_numpy(W_PROBE), dim=-1)}


def _ann(tmp_path, name, n, classes=5):
    p = tmp_path / name
    p.write_text("".join(f"video_{name}_{i:03d}.mp4,{(i * 7) % classes}\n"
                         for i in range(n)))
    return str(p)


def _datasets(tmp_path, mode, n):
    kw = dict(mode=mode, sep=",", clip_len=2, crop_size=16,
              short_side_size=20, test_num_segment=2, test_num_crop=3,
              seed=1)
    anno = _ann(tmp_path, f"{mode}.csv", n)
    return (tds.VideoClsDatasetSparse(
                anno, reader=treader.SyntheticVideoReader(32, 40), **kw),
            jds.VideoClsDatasetSparse(
                anno, reader=jreader.SyntheticVideoReader(32, 40), **kw))


def test_run_validation_matches_jax(tmp_path):
    port_ds, jax_ds = _datasets(tmp_path, "validation", 13)  # 8 + 5 padded
    got = common.run_validation(
        None, _port_probe, tloader.DataLoader(port_ds, 8, num_workers=2),
        8, "cpu", save_preds_path=str(tmp_path / "preds"))
    mesh = pmesh.make_mesh()
    ref = jcommon.run_validation(
        None, jax.jit(_jax_probe), jloader.DataLoader(jax_ds, 8,
                                                      num_workers=2),
        mesh, 1)
    assert set(got) == set(ref) == {"acc1", "acc5", "ece", "loss"}
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    assert np.load(tmp_path / "preds" / "probs.npy").shape == (13, 5)


def test_run_final_test_matches_jax(tmp_path):
    port_ds, jax_ds = _datasets(tmp_path, "test", 5)  # 30 views: 4 calls
    args = SimpleNamespace(num_workers=2, worker_mode="thread", seed=0)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    (tmp_path / "p" / "0.txt").write_text("stale\n")  # removed first
    got = common.run_final_test(None, _port_probe, port_ds, args, 8,
                                str(tmp_path / "p"), "cpu")
    ref = jcommon.run_final_test(None, jax.jit(_jax_probe), jax_ds, args,
                                 pmesh.make_mesh(), 1, str(tmp_path / "j"))
    assert got == pytest.approx(ref, rel=1e-6)
    lines = [(tmp_path / d / "0.txt").read_text().splitlines()
             for d in ("p", "j")]
    assert len(lines[0]) == len(lines[1]) == 30
    for a, b in zip(*lines):
        a, b = a.split("\t"), b.split("\t")
        assert a[0] == b[0] and a[2:] == b[2:]  # video, label, chunk, crop
        np.testing.assert_allclose(np.array(a[1].split(","), float),
                                   np.array(b[1].split(","), float),
                                   atol=2e-8)
    # the JAX package's merge reads the port's file the same
    assert jft.merge(str(tmp_path / "p"), 1) == (got["test_acc1"],
                                                 got["test_acc5"])


# ----------------------------------------------------- --finetune imports


def _vit(seed, **kw):
    torch.manual_seed(seed)
    return VisionTransformer(**TINY, **dict(dict(
        num_classes=3, all_frames=2, tubelet_size=1, init_scale=0.5), **kw))


def _finetune_args(path, **kw):
    args = argparse.Namespace(
        finetune=str(path), model_key="model|module", nb_classes=3,
        delete_head=False, label_map_path="", input_size=32, patch_size=8,
        num_frames=2, tubelet_size=1, use_mean_pooling=True)
    args.__dict__.update(kw)
    return args


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


@pytest.mark.parametrize("layout,kw", [
    ("backbone", {}),
    # the surgery runs before the prefixes go, as in unite_tpu: a
    # backbone.-prefixed head survives --delete_head, a bare one not
    ("backbone", dict(delete_head=True)),
    ("bare", dict(delete_head=True)),
    ("backbone_k710", dict(nb_classes=3)),
    ("backbone_8_frames", dict(num_frames=2))])
def test_published_weights_load_as_in_jax(tmp_path, layout, kw):
    src = _vit(1, **(dict(num_classes=710) if "k710" in layout else {}),
               **(dict(all_frames=8) if "8_frames" in layout else {}))
    prefix = "backbone." if layout.startswith("backbone") else ""
    state = {f"{prefix}{k}": v for k, v in src.state_dict().items()}
    if "8_frames" in layout:  # resampled (a buffer of this ViT: not loaded)
        state["backbone.pos_embed"] = torch.randn(1, 8 * 16, 32)
        state["backbone.head.weight"] = torch.randn(5, 32)  # another width
    torch.save({"module": state}, tmp_path / "w.pth")
    args = _finetune_args(tmp_path / "w.pth", **kw)
    dst = _vit(2)
    init = _params(dst)
    run_stage2.load_finetune_ckpt(args, dst)
    jm = jvit.VisionTransformer(num_classes=3, all_frames=2, tubelet_size=1,
                                **{k: v for k, v in TINY.items()})
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)))
    # the JAX package's chain, from the port's initial weights
    start, missing, _ = jti.merge_params(jp["params"],
                                         jti.state_to_flax_params(init))
    assert not missing
    loaded = jrun2.load_finetune_ckpt(args, jm, start)
    ref = flax_to_state_dict(loaded, patch_size=8)
    got = _params(dst)
    assert set(got) <= set(ref)
    for k in got:
        assert torch.equal(got[k], torch.as_tensor(ref[k])), k
    moved = [k for k in got if not torch.equal(got[k], init[k])]
    assert any(k.startswith("blocks.") for k in moved)
    assert ("head.weight" in moved) == (layout == "backbone")


def test_own_checkpoints_load_their_encoder_or_as_they_are(tmp_path):
    torch.manual_seed(3)
    student = AdaptationVisionTransformer(
        img_size=32, patch_size=8, encoder_embed_dim=32, encoder_depth=2,
        encoder_num_heads=2, mlp_ratio=2, num_frames=2, tubelet_size=1,
        clip_decoder_embed_dim=32, clip_output_dim=16,
        clip_return_layers=(0, 1))
    ck.save_checkpoint(str(tmp_path / "s1"), 0, student.state_dict(),
                       optimizer={"count": 4, "moments": {}})
    dst = _vit(4)
    head = {k: v for k, v in _params(dst).items()
            if k.startswith(("head.", "fc_norm."))}
    run_stage2.load_finetune_ckpt(
        _finetune_args(tmp_path / "s1" / "checkpoint-latest.pth"), dst)
    enc = {k[len("encoder."):]: v for k, v in _params(student).items()
           if k.startswith("encoder.")}
    got = _params(dst)
    shared = [k for k in got if k in enc]
    assert len(shared) == len(got) - len(head) and shared
    for k in shared:
        assert torch.equal(got[k], enc[k]), k
    for k, v in head.items():  # a stage-1 student has no head: kept
        assert torch.equal(got[k], v), k
    # a stage-2 checkpoint of the port is the ViT's own state
    src = _vit(5)
    ck.save_checkpoint(str(tmp_path / "s2"), 3, src.state_dict(),
                       optimizer={"count": 1, "moments": {}})
    dst = _vit(6)
    run_stage2.load_finetune_ckpt(
        _finetune_args(tmp_path / "s2" / "checkpoint-latest.pth"), dst)
    for k, v in _params(src).items():
        assert torch.equal(_params(dst)[k], v), k


# ----------------------------------------------------------- the entries


def _records(out):
    return [json.loads(x) for x in (Path(out) / "log.txt").read_text(
        ).splitlines()]


def _weights(tmp_path, kind):
    """The starting weights, written once: a published-layout file of a
    seeded ViT (a head at a scale that separates the classes), or a stage-1
    checkpoint of the port whose encoder is that ViT's trunk."""
    src = _vit(7, init_scale=1.0)
    path = tmp_path / f"init_{kind}.pth"
    if kind == "published":
        torch.save({"model": src.state_dict()}, path)
        return str(path)
    student = AdaptationVisionTransformer(
        img_size=32, patch_size=8, encoder_embed_dim=32, encoder_depth=2,
        encoder_num_heads=2, mlp_ratio=2, num_frames=2, tubelet_size=1,
        clip_decoder_embed_dim=32, clip_output_dim=16,
        clip_return_layers=(0, 1))
    own = {f"encoder.{k}": v for k, v in src.state_dict().items()
           if not k.startswith(("head.", "fc_norm."))}
    student.load_state_dict(dict(student.state_dict(), **own))
    ck.save_checkpoint(str(tmp_path / "s1run"), 0, student.state_dict(),
                       optimizer={"count": 0, "moments": {}})
    return str(tmp_path / "s1run" / "checkpoint-latest.pth")


def _jax_args(tmp_path, out, epochs=2, **kw):
    args = ter._stage2_args(tmp_path, out, epochs)
    args.__dict__.update(
        ann_file_train=_ann(tmp_path, "train.csv", 32, classes=3),
        ann_file_val=_ann(tmp_path, "val.csv", 12, classes=3),
        ann_file_test=_ann(tmp_path, "test.csv", 3, classes=3),
        test_num_segment=2, test_num_crop=2, drop_path=0.0,
        compute_dtype="float32", opt_eps=1e-6, lr=1e-3, min_lr=1e-4,
        warmup_lr=1e-4, delete_head=False, worker_mode="thread",
        split=",", log_freq=1)
    args.__dict__.update(kw)
    return args


def _port_args(args, out):
    """The same namespace at the JAX run's global batch, on one device."""
    port = argparse.Namespace(**vars(args))
    port.output_dir = str(out)
    port.batch_size = 8 * args.batch_size
    port.batch_size_val = 8 * args.batch_size_val
    return port


ENTRY_CASES = {
    "plain": dict(),
    "update_freq_2_clip": dict(update_freq=2, clip_grad=0.02),
    "lp_ft_ema": dict(lp_ft_epochs=1, epochs=3, model_ema=True),
    "reset_train_dataset": dict(reset_train_dataset=True,
                                train_fraction=0.5),
    "eval_only": dict(eval=True),
    # a stage-1 student carries no head: both start from a zero head
    "from_port_stage1": dict(weights="stage1", init_scale=0.0),
}


@pytest.mark.parametrize("case", list(ENTRY_CASES))
def test_entry_matches_the_jax_entry(tmp_path, case):
    kw = dict(ENTRY_CASES[case])
    weights = _weights(tmp_path, kw.pop("weights", "published"))
    jargs = _jax_args(tmp_path, tmp_path / "jax", finetune=weights, **kw)
    targs = _port_args(jargs, tmp_path / "port")
    run_stage2.main(targs, device="cpu")
    jrun2.main(jargs)
    got, ref = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref]
    keys = ("train_loss", "train_grad_norm", "val_acc1", "val_acc5",
            "val_ece", "val_loss", "test_acc1", "test_acc5")
    for g, r in zip(got, ref):
        assert {k for k in keys if k in g} == {k for k in keys if k in r}
        for k in keys:
            if k in r:
                # ECE is a difference of means of probabilities (~0.3): its
                # fp32 error is absolute, so it is held to 1e-6 beside rtol
                np.testing.assert_allclose(
                    g[k], r[k], rtol=1e-5, atol=1e-6 if k == "val_ece" else 0,
                    err_msg=f"{case} {k} {r['epoch']}")
    assert "test_acc1" in got[-1]
    if case != "eval_only":
        # the last checkpoint's parameters and EMA (decay 0.9, carried over
        # the LP-FT switch)
        from unite_tpu.utils.checkpoint import load_checkpoint as jload

        mine = ck.load_checkpoint(str(tmp_path / "port" /
                                      "checkpoint-latest.pth"))
        theirs = jload(str(tmp_path / "jax" / "checkpoint-latest.msgpack"))
        for part in ("model", "model_ema"):
            ref = flax_to_state_dict(theirs[part], patch_size=8)
            names = [k for k in mine["model_ema"]]
            assert names and set(names) <= set(ref)
            for k in names:
                np.testing.assert_allclose(
                    mine[part][k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                    atol=1e-6, err_msg=f"{case} {part} {k}")
    if case == "eval_only":
        assert len(got) == 1 and not (tmp_path / "port" /
                                      "checkpoint-latest.pth").exists()
    else:
        # the training moved the loss: the comparison is not of constants
        losses = [r["train_loss"] for r in got if "train_loss" in r]
        assert len(set(losses)) == len(losses) > 1


def _port_run(tmp_path, out, **kw):
    args = _port_args(_jax_args(tmp_path, out, finetune=_weights(
        tmp_path, "published"), epochs=3, model_ema=True, **kw), out)
    run_stage2.main(args, device="cpu")


@pytest.mark.parametrize("update_freq,stop_after", [(1, 3), (2, 5), (2, 4)])
def test_preempted_run_resumes_bitwise(tmp_path, update_freq, stop_after):
    # 4 batches an epoch; under --update_freq 2, 5 stops inside an
    # accumulation window, 4 at an epoch boundary
    kw = dict(update_freq=update_freq, clip_grad=0.02)
    _port_run(tmp_path, tmp_path / "a", **kw)
    _port_run(tmp_path, tmp_path / "b", stop_after_steps=stop_after, **kw)
    mid = ck.load_checkpoint(str(tmp_path / "b" / "checkpoint-latest.pth"))
    assert mid["epoch"] == (stop_after - 1) // 4
    assert mid["extra"]["step"] == stop_after
    assert mid["extra"].get("epoch_step", 0) == stop_after % 4
    assert "best_acc" in mid["extra"] or stop_after < 4
    acc = mid["optimizer"].get("accumulation")
    assert (acc is not None) == (update_freq > 1)
    if acc is not None:
        assert acc["mini_step"] == stop_after % 2 and (
            bool(acc["grads"]) == bool(stop_after % 2))
    _port_run(tmp_path, tmp_path / "b", **kw)
    a = ck.load_checkpoint(str(tmp_path / "a" / "checkpoint-latest.pth"))
    b = ck.load_checkpoint(str(tmp_path / "b" / "checkpoint-latest.pth"))
    assert a["epoch"] == b["epoch"] == 2 and a["extra"] == b["extra"]
    for part in ("model", "model_ema"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    oa, ob = a["optimizer"], b["optimizer"]
    assert (oa["count"], oa["schedule_count"]) == (
        ob["count"], ob["schedule_count"]) == (12 // update_freq,) * 2
    for name, mom in oa["moments"].items():
        for k in ("mu", "nu"):
            assert torch.equal(mom[k], ob["moments"][name][k]), (name, k)
    ra, rb = _records(tmp_path / "a"), _records(tmp_path / "b")
    assert [x["epoch"] for x in ra] == [y["epoch"] for y in rb] == [0, 1, 2, 3]
    assert ra[-1] == rb[-1] and "test_acc1" in ra[-1]
    for x, y in zip(ra, rb):
        # the epoch averages of the preempted epoch cover the steps of the
        # resumed run only; every later epoch and every evaluation is equal
        train = x["epoch"] > mid["epoch"] or not mid["extra"].get("epoch_step")
        assert {k: v for k, v in x.items() if "clips_per_sec" not in k
                and (train or not k.startswith("train_"))} == \
            {k: v for k, v in y.items() if "clips_per_sec" not in k
             and (train or not k.startswith("train_"))}


def test_test_best_reloads_the_best_checkpoint(tmp_path, monkeypatch):
    seen = []
    final = common.run_final_test

    def spy(state, *a, **k):
        seen.append({n: v.clone() for n, v in state.model.state_dict().items()})
        return final(state, *a, **k)

    monkeypatch.setattr(common, "run_final_test", spy)
    _port_run(tmp_path, tmp_path / "t", test_best=True)
    best = ck.load_checkpoint(str(tmp_path / "t" / "checkpoint-best.pth"))
    for k, v in best["model"].items():
        assert torch.equal(seen[0][k], v), k
    # checkpoint-best's epoch is the first whose val acc1 was the best
    vals = [r["val_acc1"] for r in _records(tmp_path / "t") if "val_acc1" in r]
    assert best["epoch"] == vals.index(max(vals))
    assert best["extra"]["best_acc"] == max(vals)


def test_entry_refuses_what_it_does_not_have(tmp_path, monkeypatch):
    base = dict(finetune="")
    for kw, match in ((dict(mixup=0.8), "item 4"), (dict(cutmix=1.0), "item 4"),
                      (dict(drop=0.1), "item 4"),
                      (dict(use_checkpoint=True), "item 4"),
                      (dict(mu_dtype="bfloat16"), "item 4"),
                      (dict(zero1=True), "item 7"), (dict(tp=2), "item 7"),
                      (dict(fsdp=True), "item 7")):
        args = _port_args(_jax_args(tmp_path, tmp_path / "r", **base, **kw),
                          tmp_path / "r")
        with pytest.raises(NotImplementedError, match=match):
            run_stage2.main(args, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = _port_args(_jax_args(tmp_path, tmp_path / "r", **base),
                      tmp_path / "r")
    with pytest.raises(NotImplementedError, match="one process"):
        run_stage2.main(args, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    # no card and no device="cpu": the entry refuses the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stage2.main(args)
