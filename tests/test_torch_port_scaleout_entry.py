"""unite_torch's stage entries under torchrun's launch, on 2 ranks over gloo
on the CPU, against one process on the same global batch.

* The data split: each data-parallel rank's training and evaluation indices
  are disjoint and together cover the set (4 ranks under --tp 2: the two
  ranks of a tensor-parallel group read the same rows); the lr tables scale
  by the global batch, --batch_size x world // --tp, as
  ``unite_tpu.train.common.lr_tables`` scales it on its devices.
* ``run_stage2.main`` (the tiny ViT of tests/test_torch_port_stage2_entry.py,
  fp32, drop path 0) at 2 ranks of 4 clips against one process of 8: the
  per-epoch train loss and grad norm, validation (acc1, acc5, ECE, loss
  over both ranks' rows) and the merged multi-view test (one view file a
  rank, merged by rank 0) agree to rtol 1e-5, the final weights to 1e-5 of
  each tensor's norm (plus the elementwise gates' atol 1e-6 as a root mean
  square); rank 0 writes the one checkpoint; a run preempted
  mid-epoch and resumed ends bit for bit where the uninterrupted 2-rank run
  ends; the ZeRO-1 and FSDP runs write the DDP run's whole payload (every
  tensor within 1e-5 of its norm), which loads into one process bit for
  bit.
* ``run_stage3.main`` (tests/test_torch_port_stage3_entry.py's tiny student,
  teacher and text features) at 2 ranks against one process: the initial
  validation and the kNN probe (features gathered over the ranks) print the
  one-process numbers, and an epoch of training, its validation and the
  merged test agree to rtol 1e-5.
"""

from __future__ import annotations

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tests.test_torch_port_stage2_entry as s2e
import tests.test_torch_port_stage3_entry as s3e
from tests.test_torch_port_entry import TINY_STUDENT
from tests.test_torch_port_scaleout_layout import launch
from unite_tpu.train import common as jcommon
from unite_torch.train import run_stage2, run_stage3
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck

REGISTER = {"vit_test_tiny": ("vit", s2e.TINY),
            "adaptation_test_tiny": ("adaptation", TINY_STUDENT),
            "clip_b16_s3_tiny": ("clip", s3e.TEACHER)}
TRAIN_KEYS = ("train_loss", "train_grad_norm")
EVAL_KEYS = ("val_acc1", "val_acc5", "val_ece", "val_loss", "test_acc1",
             "test_acc5")


def _args(builder, per_rank: int, **kw):
    """An entry namespace at ``per_rank`` times the JAX tests' batch."""
    args = builder(**kw)
    args.batch_size *= per_rank
    args.batch_size_val *= per_rank
    return args


def _close_records(got, ref, keys):
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref]
    for g, r in zip(got, ref):
        for k in keys:
            assert (k in g) == (k in r), k
            if k in r:
                np.testing.assert_allclose(
                    g[k], r[k], rtol=1e-5, atol=1e-6 if k == "val_ece" else 0,
                    err_msg=f"{k} epoch {r['epoch']}")


def _close_tensors(a: dict, b: dict, what: str):
    """Each tensor within 1e-5 of its norm, beside the elementwise gates'
    atol of 1e-6 as a root mean square (a bias that starts at 0 is all
    update)."""
    assert set(a) == set(b), what
    for k in a:
        floor = 1e-6 * b[k].numel() ** 0.5
        assert (a[k] - b[k]).norm() <= 1e-5 * b[k].norm() + floor, (what, k)


@pytest.mark.parametrize("world,tp", [(2, 1), (4, 2)])
def test_data_split_covers_and_lr_scales_by_the_global_batch(tmp_path, world,
                                                            tp):
    n = 12
    out = launch(world, "loader_split", tmp_path, {"tp": tp, "n": n})
    dp = world // tp
    for key in ("train", "val"):
        by_dp = [out[d * tp][key] for d in range(dp)]
        for d in range(dp):  # the ranks of a TP group read the same rows
            for m in range(tp):
                assert out[d * tp + m][key] == by_dp[d]
        flat = [i for shard in by_dp for i in shard]
        assert sorted(flat) == list(range(n)), key  # disjoint, covering
        assert all(len(s) == n // dp for s in by_dp)
    # the JAX package's scaling on its 8 fake devices at the same total
    # batch: 1 a device over --tp 2 ways = 4 = 2 a rank x world // tp
    ref = jcommon.lr_tables(SimpleNamespace(
        batch_size=1, tp=2, lr=1e-3, min_lr=1e-5, warmup_lr=1e-6, epochs=2,
        warmup_epochs=1, warmup_steps=-1, weight_decay=0.05,
        weight_decay_end=None), 3, 2)
    assert all(r["peak_lr"] == ref[2] for r in out)


# ------------------------------------------------------------- stage 2


@pytest.fixture(scope="module")
def stage2_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2")
    weights = s2e._weights(tmp, "published")

    def args(out, **kw):
        return _args(lambda **k: s2e._jax_args(tmp, tmp / out, **k), 4,
                     finetune=weights, epochs=2, model_ema=True, **kw)

    calls = [("stage2", args("ddp")),
             ("stage2", args("pre", stop_after_steps=3)),
             ("stage2", args("pre")),
             ("stage2", args("zero1", zero1=True)),
             ("stage2", args("fsdp", fsdp=True))]
    launch(2, "entries", tmp / "ranks", {"register": REGISTER,
                                         "calls": calls}, timeout=300)
    one = _args(lambda **k: s2e._jax_args(tmp, tmp / "one", **k), 8,
                finetune=weights, epochs=2, model_ema=True)
    run_stage2.main(one, device="cpu")
    return tmp


def _payload(tmp, run):
    return ck.load_checkpoint(str(tmp / run / "checkpoint-latest.pth"))


def test_stage2_two_ranks_train_validate_and_test_as_one(stage2_runs):
    got, ref = (s2e._records(stage2_runs / r) for r in ("ddp", "one"))
    _close_records(got, ref, TRAIN_KEYS + EVAL_KEYS)
    assert "test_acc1" in got[-1] and "val_acc1" in got[0]
    a, b = _payload(stage2_runs, "ddp"), _payload(stage2_runs, "one")
    for part in ("model", "model_ema"):
        _close_tensors(a[part], b[part], part)
    assert a["extra"]["step"] == b["extra"]["step"] == 8


def test_stage2_rank0_writes_one_checkpoint_and_merges_every_rank(
        stage2_runs):
    out = stage2_runs / "ddp"
    names = sorted(p.name for p in out.iterdir())
    assert [n for n in names if n.startswith("checkpoint")] == [
        "checkpoint-1.pth", "checkpoint-best.pth", "checkpoint-latest.pth"]
    # one view file a rank (3 videos x 4 views over 2 ranks), one merge
    views = [len((out / f"{r}.txt").read_text().splitlines())
             for r in range(2)]
    assert views == [6, 6]
    assert len(s2e._records(out)) == 3


def test_stage2_preempted_two_ranks_resume_bitwise(stage2_runs):
    a, b = _payload(stage2_runs, "ddp"), _payload(stage2_runs, "pre")
    assert a["epoch"] == b["epoch"] == 1 and a["extra"] == b["extra"]
    for part in ("model", "model_ema"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for name, mom in a["optimizer"]["moments"].items():
        for k in ("mu", "nu"):
            assert torch.equal(mom[k], b["optimizer"]["moments"][name][k])
    ra, rb = s2e._records(stage2_runs / "ddp"), s2e._records(
        stage2_runs / "pre")
    assert ra[-1] == rb[-1]


@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_stage2_sharded_checkpoints_are_whole_and_load_into_one_process(
        stage2_runs, layout):
    a, ref = _payload(stage2_runs, layout), _payload(stage2_runs, "ddp")
    for part in ("model", "model_ema"):
        assert {k: tuple(v.shape) for k, v in a[part].items()} == {
            k: tuple(v.shape) for k, v in ref[part].items()}
        _close_tensors(a[part], ref[part], part)
    moms = {f"{n}.{k}": v for n, m in a["optimizer"]["moments"].items()
            for k, v in m.items()}
    ref_moms = {f"{n}.{k}": v for n, m in ref["optimizer"]["moments"].items()
                for k, v in m.items()}
    assert {k: tuple(v.shape) for k, v in moms.items()} == {
        k: tuple(v.shape) for k, v in ref_moms.items()}
    _close_records(s2e._records(stage2_runs / layout),
                   s2e._records(stage2_runs / "ddp"),
                   TRAIN_KEYS + EVAL_KEYS)
    # into one process, as an auto-resume would take it
    from unite_torch.optim.factory import create_optimizer

    model = run_stage2.build_model(SimpleNamespace(
        model="vit_test_tiny", nb_classes=3, num_frames=2, tubelet_size=1,
        fc_drop_rate=0.0, drop=0.0, attn_drop_rate=0.0, drop_path=0.0,
        use_learnable_pos_emb=False, use_mean_pooling=True, init_scale=0.5,
        head_type="linear", head_hidden_dim=256, compute_dtype="float32"),
        device="cpu")
    tx, _ = create_optimizer("adamw", 1e-3, model, device="cpu")
    state = TrainState(model, tx, ema_decay=0.9)
    ck.restore_train_state(state, a)
    for k, v in model.state_dict().items():
        assert torch.equal(v, a["model"][k]), k
    named = dict(model.named_parameters())
    for n, mom in a["optimizer"]["moments"].items():
        for k, v in mom.items():
            assert torch.equal(tx.state[named[n]][k], v), (n, k)
    for k, v in state.ema_params.items():
        assert torch.equal(v, a["model_ema"][k]), k


# ------------------------------------------------------------- stage 3


def _probe_lines(text: str) -> list:
    return re.findall(r"(Initial val: .*|kNN probe .*)", text)


def test_stage3_two_ranks_probe_train_and_test_as_one(tmp_path, capsys):
    def args(out, per_rank):
        return _args(lambda **k: s3e._jax_args(tmp_path, tmp_path / out,
                                               **k), per_rank,
                     initial_validation=True, knn_eval=True)

    launch(2, "entries", tmp_path / "ranks",
           {"register": REGISTER, "calls": [("stage3", args("two", 4))]},
           timeout=300)
    capsys.readouterr()
    run_stage3.main(args("one", 8), device="cpu")
    one_lines = _probe_lines(capsys.readouterr().out)
    two_lines = _probe_lines((tmp_path / "ranks" / "rank0.log").read_text())
    assert len(one_lines) == 2 and "12 val" in one_lines[1]
    assert two_lines == one_lines
    _close_records(s3e._records(tmp_path / "two"),
                   s3e._records(tmp_path / "one"), TRAIN_KEYS + EVAL_KEYS)
    a = ck.load_checkpoint(str(tmp_path / "two" / "checkpoint-latest.pth"))
    b = ck.load_checkpoint(str(tmp_path / "one" / "checkpoint-latest.pth"))
    _close_tensors(a["model"], b["model"], "model")
