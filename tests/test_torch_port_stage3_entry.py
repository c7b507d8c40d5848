"""unite_torch's stage-3 entry (``run_stage3.main``) against unite_tpu's, on
the CPU, with tiny models in fp32 and drop path 0.

* The pieces: ``load_classifier_head`` over the port's stage-3 and stage-2
  checkpoints (against JAX's reading of the same heads in its own
  checkpoints), a published stage-2 ``.pth`` and a bare Linear file (the
  same files for both), a head of another shape and the ``--eval`` glob;
  ``collect_features`` and ``run_knn_probe``; ``train_one_epoch``'s array
  sink and the ``cmp_*`` table from it.
* Entry against entry: ``run_stage3.main(device="cpu")`` at batch 8 on one
  device against JAX's ``run_stage3.main`` on 8 fake CPU devices at 1 a
  device, from one stage-2-layout weight file (its ``head.*`` the
  classifier), one decoder file and one CLIP file: the per-epoch train loss
  and selection diagnostics, the ``cmp_*`` table, the validation acc1 /
  acc5 / ECE / loss and the merged test accuracies agree to rtol 1e-5
  (fp32 summation order), and so does every final parameter, the
  classifier unchanged. The cases: ``--clip_text_features`` with a target
  longer than the source and the kNN probe, ``--clip_text_init`` with
  ``--clip_bpe_path`` (synthetic merges), ``--allow_uniform_clip`` and
  ``--eval``. ``--eval`` from each entry's own stage-3 checkpoint (the
  port's combined ``.pth``, JAX's ``.msgpack``): the port's per-view test
  rows equal its training call's final test on the same weights, and
  JAX's to rtol 1e-5.
* The refusals, and a run preempted mid-epoch or at an epoch boundary
  (drop path 0.1) and auto-resumed that ends bit for bit where an
  uninterrupted run ends; ``device_prefetch`` has ended its producer when
  its generator is closed; ``chip_smoke.STAGE3_ARGS`` is the stage-3
  config plus ``stage3.sh``.
"""

import argparse
import json
import re
import shlex
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_entry_resume  # noqa: F401 (registers the JAX tiny models)
# registers the port's adaptation_test_tiny (TINY_STUDENT) with the stage-1
# entry tests' teachers, whichever file a worker imports first
from tests.test_torch_port_entry import TINY_STUDENT
from unite_tpu import config as jconfig
from unite_tpu.data import datasets as jds
from unite_tpu.data import loader as jloader
from unite_tpu.data import video_reader as jreader
from unite_tpu.engines import selftrain as jst
from unite_tpu.models import clip as jclip
from unite_tpu.parallel import mesh as pmesh
from unite_tpu.train import args as jargs
from unite_tpu.train import common as jcommon
from unite_tpu.train import run_stage3 as jrun3
from unite_tpu.utils import checkpoint as jck
from unite_tpu.utils.registry import _MODEL_REGISTRY as JREG
from unite_tpu.utils.registry import register_model as jregister
from unite_torch import config as tconfig
from unite_torch.data import datasets as tds
from unite_torch.data import loader as tloader
from unite_torch.data import video_reader as treader
from unite_torch.engines import selftrain as tst
from unite_torch.models.adaptation import AdaptationVisionTransformer
from unite_torch.models.clip import CLIPVisionTransformer
from unite_torch.models.clip_text import CLIPTextTransformer
from unite_torch.train import args as targs
from unite_torch.train import common
from unite_torch.train import run_stage3
from unite_torch.utils import checkpoint as ck
from unite_torch.utils.flax_bridge import flax_to_state_dict
from unite_torch.utils.registry import _MODEL_REGISTRY, register_model

ROOT = Path(__file__).resolve().parents[1]
# a teacher at 64^2 in patches of 16 (the importer reads "b16"): the
# student's 4x4 grid; 512 wide at the output, as the text tower
TEACHER = dict(patch_size=16, width=32, layers=2, heads=2, output_dim=512)
MERGES = ["#version: 0.2", "h e", "l l", "he ll", "hell o</w>", "a</w>",
          "p e", "pe r", "per son</w>", "v i", "vi deo</w>", "o f</w>"]

if "clip_b16_s3_tiny" not in _MODEL_REGISTRY:

    @register_model
    def clip_b16_s3_tiny(**kwargs):
        return CLIPVisionTransformer(**TEACHER, **kwargs)

if "clip_b16_s3_tiny" not in JREG:

    @jregister
    def clip_b16_s3_tiny(**kwargs):
        return jclip.CLIPVisionTransformer(
            input_resolution=kwargs["input_resolution"],
            return_attn=kwargs.get("return_attn", True),
            return_index=kwargs.get("return_index", (0,)),
            dtype=kwargs.get("dtype", jnp.float32), **TEACHER)


def _ann(tmp_path, name, n, classes=3):
    p = tmp_path / name
    p.write_text("".join(f"video_{name}_{i:03d}.mp4,{(i * 7) % classes}\n"
                         for i in range(n)))
    return str(p)


def _records(out):
    return [json.loads(x) for x in (Path(out) / "log.txt").read_text(
        ).splitlines()]


# ------------------------------------------------------- the classifier head


def _head_args(**kw):
    args = SimpleNamespace(eval=False, student_init="", src_classifier_init="",
                           model_key="model|module")
    args.__dict__.update(kw)
    return args


def _rand_head(seed, rows=3, width=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, width)).astype(np.float32),
            rng.standard_normal(rows).astype(np.float32))


def _write_head(tmp_path, kind, seed, rows=3):
    """One file of ``kind`` for the port and its JAX counterpart (the same
    file where JAX reads the port's format), holding a head of ``rows``."""
    w, b = _rand_head(seed, rows)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    d = tmp_path / f"{kind}_{seed}"
    d.mkdir()
    trunk = {"blocks.0.norm1.weight": torch.ones(32)}
    if kind == "stage3":
        ck.save_checkpoint(str(d / "p"), 1, {
            "model.encoder.norm.weight": torch.ones(32),
            "classifier.weight": wt, "classifier.bias": bt},
            optimizer={"count": 0, "moments": {}})
        jck.save_checkpoint(str(d / "j"), 1, {
            "model": {"encoder": {"norm": {"scale": np.ones(32)}}},
            "classifier": {"kernel": w.T, "bias": b}})
        return (str(d / "p" / "checkpoint-latest.pth"),
                str(d / "j" / "checkpoint-latest.msgpack"), (w, b))
    if kind == "stage2":
        ck.save_checkpoint(str(d / "p"), 1, dict(
            trunk, **{"head.weight": wt, "head.bias": bt}),
            optimizer={"count": 0, "moments": {}})
        jck.save_checkpoint(str(d / "j"), 1, {
            "blocks_0": {"norm1": {"scale": np.ones(32)}},
            "head": {"kernel": w.T, "bias": b}})
        return (str(d / "p" / "checkpoint-latest.pth"),
                str(d / "j" / "checkpoint-latest.msgpack"), (w, b))
    path = d / "w.pth"
    if kind == "published":
        torch.save({"module": dict(trunk, **{"head.weight": wt,
                                             "head.bias": bt})}, path)
    else:  # a bare Linear's state dict
        torch.save({"weight": wt, "bias": bt}, path)
    return str(path), str(path), (w, b)


def _load_both(args_port, args_jax):
    torch.manual_seed(0)
    head = run_stage3.build_classifier(SimpleNamespace(nb_classes=3), 32,
                                       device="cpu")
    init = (head.weight.detach().clone(), head.bias.detach().clone())
    got = run_stage3.load_classifier_head(args_port, head)
    ref = jrun3.load_classifier_head(args_jax, {
        "kernel": init[0].numpy().T, "bias": init[1].numpy()})
    np.testing.assert_array_equal(head.weight.detach().numpy(),
                                  np.asarray(ref["kernel"]).T)
    np.testing.assert_array_equal(head.bias.detach().numpy(),
                                  np.asarray(ref["bias"]))
    return got, head, init


@pytest.mark.parametrize("kind", ["stage3", "stage2", "published", "linear"])
@pytest.mark.parametrize("flag", ["student_init", "src_classifier_init"])
def test_classifier_head_loads_as_in_jax(tmp_path, kind, flag):
    port, jax_path, (w, b) = _write_head(tmp_path, kind, 1)
    got, head, _ = _load_both(_head_args(**{flag: port}),
                              _head_args(**{flag: jax_path}))
    assert got == port
    np.testing.assert_array_equal(head.weight.detach().numpy(), w)
    np.testing.assert_array_equal(head.bias.detach().numpy(), b)


def test_classifier_head_skips_other_shapes_and_takes_the_eval_glob(
        tmp_path, capsys):
    wide, _, _ = _write_head(tmp_path, "published", 2, rows=5)
    s2, s2_jax, (w2, b2) = _write_head(tmp_path, "stage2", 3)
    # a head of 5 classes is skipped with JAX's message, the next taken
    got, head, _ = _load_both(
        _head_args(src_classifier_init=wide, student_init=s2),
        _head_args(src_classifier_init=wide, student_init=s2_jax))
    assert got == s2 and "Skipping classifier head from" in \
        capsys.readouterr().out
    np.testing.assert_array_equal(head.weight.detach().numpy(), w2)
    # nothing that fits: the initialised head stays
    got, head, init = _load_both(_head_args(src_classifier_init=wide),
                                 _head_args(src_classifier_init=wide))
    assert got is None and torch.equal(head.weight.detach(), init[0])
    # under --eval the first src_classifier* beside --student_init wins
    lin, _, (wl, bl) = _write_head(tmp_path, "linear", 4)
    for name in ("src_classifier-latest.pth", "src_classifier-z.pth"):
        Path(s2).with_name(name).write_bytes(Path(lin).read_bytes())
        Path(s2_jax).with_name(name).write_bytes(Path(lin).read_bytes())
    got, head, _ = _load_both(_head_args(eval=True, student_init=s2),
                              _head_args(eval=True, student_init=s2_jax))
    assert Path(got).name == "src_classifier-latest.pth"
    np.testing.assert_array_equal(head.weight.detach().numpy(), wl)
    got, head, _ = _load_both(_head_args(student_init=s2),
                              _head_args(student_init=s2_jax))
    assert got == s2  # not without --eval


# ----------------------------------------------------- features and the sink


W_FEATS = np.random.default_rng(5).standard_normal((3, 6)).astype(np.float32)


def _jax_feats(state, batch):
    x = jnp.mean(batch["videos"].astype(jnp.float32), axis=(1, 2, 3))
    return {"feats": jnp.tanh(x @ jnp.asarray(W_FEATS))}


def _port_feats(state, batch):
    x = batch["videos"].float().mean(dim=(1, 2, 3))
    return {"feats": torch.tanh(x @ torch.from_numpy(W_FEATS))}


def _loaders(tmp_path, name, n, batch=8):
    kw = dict(mode="validation", sep=",", clip_len=2, crop_size=16,
              short_side_size=20, seed=1)
    anno = _ann(tmp_path, f"{name}.csv", n, classes=4)
    return (tloader.DataLoader(tds.VideoClsDatasetSparse(
                anno, reader=treader.SyntheticVideoReader(32, 40), **kw),
                batch, num_workers=2),
            jloader.DataLoader(jds.VideoClsDatasetSparse(
                anno, reader=jreader.SyntheticVideoReader(32, 40), **kw),
                batch, num_workers=2))


@pytest.mark.parametrize("max_videos", [512, 9, 0])
def test_features_and_knn_probe_match_jax(tmp_path, max_videos):
    train_p, train_j = _loaders(tmp_path, "train", 21)   # 8 + 8 + 5 padded
    val_p, val_j = _loaders(tmp_path, "val", 13)
    mesh = pmesh.make_mesh()
    f, lab = common.collect_features(None, _port_feats, train_p, 8, "cpu",
                                     max_videos=max(max_videos, 1))
    rf, rl = jcommon.collect_features(None, jax.jit(_jax_feats), train_j,
                                      mesh, 1, max_videos=max(max_videos, 1))
    np.testing.assert_allclose(f, rf, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(lab, rl)
    assert len(f) == (21 if max_videos == 512 else 16 if max_videos == 9
                      else 8)
    if max_videos == 0:
        # an empty side: no probe
        empty = tloader.DataLoader([], 8)
        assert common.run_knn_probe(None, _port_feats, empty, val_p, 8, 4,
                                    "cpu") == {}
        return
    got = common.run_knn_probe(None, _port_feats, train_p, val_p, 8, 4,
                               "cpu", k=5, max_videos=max_videos)
    ref = jcommon.run_knn_probe(None, jax.jit(_jax_feats), train_j, val_j,
                                mesh, 1, 4, k=5, max_videos=max_videos)
    assert got == ref and set(got) == {"knn_top1", "knn_top5"}


def test_array_sink_and_prediction_table_match_jax():
    rng = np.random.default_rng(6)
    steps = [{"loss": np.float32(rng.random()),
              "preds_t": rng.integers(0, 4, 5),
              "clip_preds_t": rng.integers(0, 4, 5),
              "labels_t": rng.integers(0, 4, 5)} for _ in range(7)]
    it = iter(steps)

    def port_step(state, batch):
        return {k: torch.as_tensor(v) for k, v in next(it).items()}

    jt = iter(steps)

    def jax_step(state, batch, rng):
        return state, {k: jnp.asarray(v) for k, v in next(jt).items()}

    sink, jsink = {}, {}
    batches = [{"videos_s": np.zeros((5, 1))}] * 7
    _, stats, _ = common.train_one_epoch(None, port_step, batches, 0,
                                         log_freq=3, array_sink=sink)
    _, jstats, _ = jcommon.train_one_epoch(None, jax_step, batches, 0,
                                           log_freq=3, array_sink=jsink)
    assert set(sink) == set(jsink) == {"preds_t", "clip_preds_t", "labels_t"}
    for k in sink:
        assert isinstance(sink[k], np.ndarray) and sink[k].shape == (35,)
        np.testing.assert_array_equal(sink[k], np.concatenate(jsink[k]))
    np.testing.assert_allclose(stats["loss"], jstats["loss"], rtol=1e-6)
    got = tst.compare_model_predictions(sink["preds_t"],
                                        sink["clip_preds_t"],
                                        sink["labels_t"])
    ref = jst.compare_model_predictions(np.concatenate(jsink["preds_t"]),
                                        np.concatenate(jsink["clip_preds_t"]),
                                        np.concatenate(jsink["labels_t"]))
    assert got == ref
    # no sink: the arrays are dropped
    it = iter(steps)
    common.train_one_epoch(None, port_step, batches, 0, log_freq=3)


def test_prefetch_producer_ends_when_the_generator_closes():
    # a preempted epoch closes its batch stream: the producer (which runs
    # the zero-shot teacher on each batch it builds) must have ended when
    # the entry goes on, not build and launch behind its back
    built = []

    def slow():
        for i in range(100):
            time.sleep(0.01)
            built.append(i)
            yield i

    gen = tloader.device_prefetch(slow(), lambda b: b, depth=2)
    assert next(gen) == 0
    gen.close()
    n = len(built)
    time.sleep(0.1)
    assert len(built) == n <= 4
    assert not any(t.name.endswith("(producer)") and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------------------ the entries


def _weights(tmp_path):
    """The starting weights, written once: a stage-2-layout file (the
    encoder's trunk as a ViT's, with ``head.*`` and ``fc_norm.*`` and no
    ``norm``), the CLIP decoders and the CLIP teacher, all of seeded port
    models, and the text artifacts."""
    d = tmp_path / "init"
    if d.exists():
        return d
    d.mkdir()
    torch.manual_seed(7)
    student = AdaptationVisionTransformer(
        num_frames=2, tubelet_size=1, clip_return_layers=(0,),
        **TINY_STUDENT)
    sd = student.state_dict()
    trunk = {k[len("encoder."):]: v for k, v in sd.items()
             if k.startswith("encoder.") and not k.startswith("encoder.norm.")}
    w, b = _rand_head(8, rows=12)
    # a head whose confidences straddle --clip_threshold 0.1 at 12 classes:
    # both of clip_matchORconf's branches select
    trunk.update({"head.weight": torch.from_numpy(w) * 0.02,
                  "head.bias": torch.from_numpy(b) * 0.01,
                  "fc_norm.weight": torch.ones(32),
                  "fc_norm.bias": torch.zeros(32)})
    torch.save({"model": trunk}, d / "stage2.pth")
    torch.save({"model": {k: v for k, v in sd.items()
                          if k.startswith("clip_decoder.")}},
               d / "decoder.pth")
    teacher = CLIPVisionTransformer(input_resolution=64, return_attn=True,
                                    return_index=(0,), **TEACHER)
    torch.save({"model": teacher.state_dict()}, d / "clip.pth")
    np.save(d / "text.npy", np.random.default_rng(9).standard_normal(
        (12, 512)).astype(np.float32))
    return d


def _jax_args(tmp_path, out, **kw):
    d = _weights(tmp_path)
    args = jconfig.parse_with_config(jargs.stage3_parser(), [])
    args.__dict__.update(
        model="adaptation_test_tiny", clip_teacher="clip_b16_s3_tiny",
        clip_return_layers=[0], clip_input_resolution=64,
        ann_file_train=_ann(tmp_path, "src.csv", 16, classes=12),
        ann_file_train_target=_ann(tmp_path, "tgt.csv", 16, classes=12),
        ann_file_val=_ann(tmp_path, "val.csv", 12, classes=12),
        ann_file_test=_ann(tmp_path, "test.csv", 3, classes=12),
        nb_classes=12, data_set="Kinetics_sparse", split=",",
        synthetic_data=True, input_size=32, short_side_size=32, patch_size=8,
        num_frames=2, tubelet_size=1, mask_ratio=0.5, batch_size=1,
        batch_size_val=1, epochs=1, warmup_epochs=0, num_workers=2,
        log_freq=1, output_dir=str(out), overwrite="allow", test_best=False,
        test_num_segment=2, test_num_crop=2, seed=11, drop_path=0.0,
        compute_dtype="float32", opt_eps=1e-6, lr=2e-3, min_lr=1e-4,
        warmup_lr=1e-4, worker_mode="thread", checkpoints_enabled=True,
        student_init=str(d / "stage2.pth"),
        clip_decoder_init=str(d / "decoder.pth"),
        clip_init=str(d / "clip.pth"),
        clip_text_features=str(d / "text.npy"), initial_validation=False)
    args.__dict__.update(kw)
    return args


def _port_args(args, out):
    """The same namespace at the JAX run's global batch, on one device."""
    port = argparse.Namespace(**vars(args))
    port.output_dir = str(out)
    port.batch_size = 8 * args.batch_size
    port.batch_size_val = 8 * args.batch_size_val
    return port


def _text_init(tmp_path):
    """The text tower (the full geometry the loader takes, random weights
    under the OpenAI names) and a synthetic merges file."""
    d = _weights(tmp_path)
    torch.manual_seed(10)
    text = CLIPTextTransformer()
    torch.save({"state_dict": {k: torch.randn_like(v) * 0.02
                               for k, v in text.state_dict().items()}},
               d / "text.pth")
    (d / "merges.txt").write_text("\n".join(MERGES) + "\n")
    return dict(clip_text_features="", clip_text_init=str(d / "text.pth"),
                clip_bpe_path=str(d / "merges.txt"))


ENTRY_CASES = {
    "text_features_longer_target_knn": lambda t: dict(
        epochs=2, ann_file_train_target=_ann(t, "tgt24.csv", 24, classes=12),
        initial_validation=True, knn_eval=True, knn_max_videos=16,
        save_preds_path=str(t / "preds_{}")),
    "text_init_and_merges": _text_init,
    "uniform_clip": lambda t: dict(clip_text_features="",
                                   allow_uniform_clip=True),
    "eval_only": lambda t: dict(eval=True),
}


@pytest.mark.parametrize("case", list(ENTRY_CASES))
def test_entry_matches_the_jax_entry(tmp_path, case):
    kw = ENTRY_CASES[case](tmp_path)
    preds = kw.pop("save_preds_path", None)
    jargs_ = _jax_args(tmp_path, tmp_path / "jax", **kw,
                       **({"save_preds_path": preds.format("jax")}
                          if preds else {}))
    targs_ = _port_args(jargs_, tmp_path / "port")
    if preds:
        targs_.save_preds_path = preds.format("port")
    run_stage3.main(targs_, device="cpu")
    jrun3.main(jargs_)
    got, ref = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if "clips_per_sec" in k:
                continue
            # ECE is a difference of means of probabilities: its fp32
            # error is absolute, so it is held to 1e-6 beside rtol
            np.testing.assert_allclose(
                g[k], r[k], rtol=1e-5, atol=1e-6 if k == "val_ece" else 0,
                err_msg=f"{case} {k} {r['epoch']}")
    assert "test_acc1" in got[-1]
    d = _weights(tmp_path)
    head = torch.load(d / "stage2.pth")["model"]
    if case == "eval_only":
        assert len(got) == 1
        return
    train = [r for r in got if "train_loss" in r]
    for key in ("train_sel_ratio", "train_correct_precision",
                "train_correct_recall", "train_match_select_rate",
                "cmp_student_acc", "cmp_clip_acc", "cmp_student_clip_agree",
                "val_acc1"):
        assert all(key in r for r in train), key
    if preds:
        for run in ("port", "jax"):
            for sub in ("initial", "epoch0", "epoch1"):
                assert (Path(preds.format(run)) / sub / "probs.npy").exists()
        np.testing.assert_allclose(
            np.load(Path(preds.format("port")) / "epoch1" / "probs.npy"),
            np.load(Path(preds.format("jax")) / "epoch1" / "probs.npy"),
            rtol=1e-5, atol=1e-6)
    # every final parameter, and the classifier as it was loaded
    mine = ck.load_checkpoint(str(tmp_path / "port" / "checkpoint-latest.pth"))
    theirs = jck.load_checkpoint(str(tmp_path / "jax" /
                                     "checkpoint-latest.msgpack"))
    ref = {f"model.{k}": v for k, v in flax_to_state_dict(
        theirs["model"]["model"], patch_size=8).items()}
    ref["classifier.weight"] = torch.from_numpy(
        np.asarray(theirs["model"]["classifier"]["kernel"]).T.copy())
    ref["classifier.bias"] = torch.from_numpy(
        np.asarray(theirs["model"]["classifier"]["bias"]))
    params = dict(run_stage3.combine(
        AdaptationVisionTransformer(num_frames=2, tubelet_size=1,
                                    clip_return_layers=(0,), **TINY_STUDENT),
        torch.nn.Linear(32, 12)).named_parameters())
    assert set(params) <= set(mine["model"]) and set(params) <= set(ref)
    for k in params:
        np.testing.assert_allclose(mine["model"][k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{case} {k}")
    assert torch.equal(mine["model"]["classifier.weight"], head["head.weight"])
    assert torch.equal(mine["model"]["classifier.bias"], head["head.bias"])
    # the training moved the encoder: the comparison is not of constants
    start = torch.load(d / "stage2.pth")["model"]["blocks.0.attn.qkv.weight"]
    assert not torch.equal(mine["model"]["model.encoder.blocks.0.attn.qkv."
                                        "weight"], start)


def _views(out):
    """A final test's per-view rows (``{output_dir}/0.txt``): video, label,
    chunk and crop, and the probabilities apart."""
    rows = [line.split("\t") for line in (Path(out) / "0.txt").read_text(
        ).splitlines()]
    return ([(r[0], *r[2:]) for r in rows],
            np.array([[float(p) for p in r[1].split(",")] for r in rows]))


def test_eval_from_a_stage3_checkpoint_matches_jax(tmp_path):
    # one epoch in each entry, then --eval from each one's own stage-3
    # checkpoint: the port's combined .pth, JAX's combined .msgpack
    jargs_ = _jax_args(tmp_path, tmp_path / "jax")
    run_stage3.main(_port_args(jargs_, tmp_path / "port"), device="cpu")
    jrun3.main(jargs_)
    jeval = _jax_args(tmp_path, tmp_path / "jax_eval", eval=True,
                      student_init=str(tmp_path / "jax" /
                                       "checkpoint-latest.msgpack"))
    teval = _port_args(jeval, tmp_path / "port_eval")
    teval.student_init = str(tmp_path / "port" / "checkpoint-latest.pth")
    run_stage3.main(teval, device="cpu")
    jrun3.main(jeval)
    # every weight of the checkpoint came back: the --eval call's views are
    # those of the training call's own final test, on the same weights
    assert (Path(tmp_path / "port_eval" / "0.txt").read_text()
            == Path(tmp_path / "port" / "0.txt").read_text())
    (got_ids, got), (ref_ids, ref) = (_views(tmp_path / "port_eval"),
                                      _views(tmp_path / "jax_eval"))
    assert got_ids == ref_ids and got.shape == (3 * 2 * 2, 12)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # not a head on a fresh encoder: the stage-2 file's views differ
    run_stage3.main(_port_args(_jax_args(tmp_path, tmp_path / "s2_eval",
                                         eval=True), tmp_path / "s2_eval"),
                    device="cpu")
    assert np.abs(_views(tmp_path / "s2_eval")[1] - got).max() > 1e-4
    mine, theirs = (_records(tmp_path / "port_eval"),
                    _records(tmp_path / "jax_eval"))
    assert len(mine) == len(theirs) == 1
    for k in ("test_acc1", "test_acc5"):
        np.testing.assert_allclose(mine[0][k], theirs[0][k], rtol=1e-5)


def test_entry_refuses_what_it_does_not_have(tmp_path, monkeypatch):
    def args(**kw):
        return _port_args(_jax_args(tmp_path, tmp_path / "r", **kw),
                          tmp_path / "r")

    with pytest.raises(RuntimeError, match="needs the CLIP zero-shot teacher"):
        run_stage3.main(args(clip_text_features=""), device="cpu")
    with pytest.raises(RuntimeError, match="needs the CLIP zero-shot teacher"):
        run_stage3.main(args(clip_text_features="", selection_strategy=
                             "clip_only"), device="cpu")
    with pytest.raises(ValueError, match="--unmasked_classification"):
        run_stage3.main(args(pseudolabel_threshold=0.5), device="cpu")
    for kw, match in ((dict(mu_dtype="bfloat16"), "fp32 moments"),
                      (dict(zero1=True), "item 7"), (dict(tp=2), "item 7"),
                      (dict(use_checkpoint=True), "use_checkpoint")):
        with pytest.raises(NotImplementedError, match=match):
            run_stage3.main(args(**kw), device="cpu")
    # no card and no device="cpu": the entry refuses the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stage3.main(args())


def _port_run(tmp_path, out, **kw):
    run_stage3.main(_port_args(_jax_args(
        tmp_path, out, epochs=2, drop_path=0.1, auto_resume=True,
        initial_validation=True, **kw), out), device="cpu")


@pytest.mark.parametrize("stop_after", [3, 2])
def test_preempted_run_resumes_bitwise(tmp_path, stop_after):
    # 2 steps an epoch: 3 stops inside epoch 1 (its target batch in the
    # cycled stream's second pass), 2 at the epoch boundary; drop path
    # draws follow the step counter across the restart
    _port_run(tmp_path, tmp_path / "a")
    _port_run(tmp_path, tmp_path / "b", stop_after_steps=stop_after)
    mid = ck.load_checkpoint(str(tmp_path / "b" / "checkpoint-latest.pth"))
    assert mid["epoch"] == (stop_after - 1) // 2
    assert mid["extra"]["step"] == stop_after
    assert mid["extra"].get("epoch_step", 0) == stop_after % 2
    assert "best_acc" in mid["extra"]
    _port_run(tmp_path, tmp_path / "b")
    a = ck.load_checkpoint(str(tmp_path / "a" / "checkpoint-latest.pth"))
    b = ck.load_checkpoint(str(tmp_path / "b" / "checkpoint-latest.pth"))
    assert a["epoch"] == b["epoch"] == 1 and a["extra"] == b["extra"]
    assert set(a["model"]) == set(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"] == 4
    for name, mom in oa["moments"].items():
        for k in ("mu", "nu"):
            assert torch.equal(mom[k], ob["moments"][name][k]), (name, k)
    ra, rb = _records(tmp_path / "a"), _records(tmp_path / "b")
    assert [x["epoch"] for x in ra] == [y["epoch"] for y in rb] == [0, 1, 2]
    assert ra[-1] == rb[-1] and "test_acc1" in ra[-1]
    for x, y in zip(ra, rb):
        # a preempted epoch's averages and table cover the resumed run's
        # steps only; every later epoch and every evaluation is equal
        whole = x["epoch"] > mid["epoch"] or not mid["extra"].get(
            "epoch_step")
        assert {k: v for k, v in x.items() if "clips_per_sec" not in k
                and (whole or not k.startswith(("train_", "cmp_")))} == \
            {k: v for k, v in y.items() if "clips_per_sec" not in k
             and (whole or not k.startswith(("train_", "cmp_")))}


def test_chip_smoke_command_line_is_config_plus_launcher():
    # stage3.sh's command as the shell runs it at its default EPOCHS=20
    # (warmup EPOCHS / 5), then the smoke's --epochs 2 --warmup_epochs 0
    text = (ROOT / "stage3.sh").read_text()
    assert "EPOCHS=${EPOCHS:-20}" in text
    cmd = text[text.index("python -m"):].replace(
        "$((EPOCHS / 5))", "4").replace('"$EPOCHS"', "20")
    words = shlex.split(cmd.replace("\\\n", " "))[3:]
    assert words[-1] == "$@"
    pairs = list(zip(words[:-1:2], words[1:-1:2]))
    assert all(f.startswith("--") for f, _ in pairs)
    launcher = [x for f, v in pairs if f not in (
        "--config", "--dataset", "--output_dir", "--student_init")
        for x in (f, v)]
    assert "--clip_threshold" in launcher and "--num_workers" in launcher
    ref = jconfig.parse_with_config(jargs.stage3_parser(), [
        "--config", str(ROOT / "configs/stage3_config.yaml")] + launcher
        + ["--epochs", "2", "--warmup_epochs", "0"])
    got = tconfig.parse_with_config(targs.stage3_parser(),
                                    chip_smoke.STAGE3_ARGS)
    assert vars(got) == dict(vars(ref), config=None)
    assert re.search(r"--batch_size 5\b", " ".join(chip_smoke.STAGE3_ARGS))
