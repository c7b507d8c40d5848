"""unite_torch as a package: no JAX anywhere, and no quiet move to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import unite_torch
from unite_torch.engines.finetune import make_eval_step, make_finetune_train_step
from unite_torch.engines.pretrain_umt import make_pretrain_train_step
from unite_torch.engines.selftrain import (make_selftrain_eval_step,
                                           make_selftrain_step)
from unite_torch.optim.factory import create_optimizer
from unite_torch.train import run_stage1
from unite_torch.train.args import stage1_parser
from unite_torch.tools import classify, quant_kernel_probe, record_losses
from unite_torch.train.run_stage3 import build_classifier

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "unite_tpu")
# the modules of each slice, named so that a module left out of the walk
# fails the check
SLICE_MODULES = ("ops.attention", "models.adaptation", "engines.finetune",
                 "engines.selftrain", "models.clip_text", "train.run_stage3",
                 "utils.knn", "utils.metrics", "train.args", "config",
                 "data.video_reader", "data.samplers", "data.transforms",
                 "data.datasets", "data.build", "data.sharding", "data.loader",
                 "utils.logging", "utils.checkpoint", "utils.torch_import",
                 "train.common", "train.run_stage1", "ops.matmul", "ops.quant",
                 "tools.quant_kernel_probe", "train.run_stage2",
                 "data.functional", "data.rand_augment",
                 "data.random_erasing", "data.datasets_extra",
                 "ops.eval_transforms", "native._build", "ops.mixup",
                 "data.collate_mixup", "tools.export_torch",
                 "tools.classify", "tools.record_losses",
                 "tools.extract_clip", "tools.flops")
# imported only where their paths are used (a YAML file, the PIL transform
# path, the OpenCV reader, the logging flags)
LAZY = ("yaml", "PIL", "cv2", "tensorboardX", "wandb")


def _run(code_or_args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    # a subprocess: this test process has JAX loaded by tests/conftest.py
    code = (
        "import importlib, pkgutil, sys, unite_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(unite_torch.__path__,"
        " 'unite_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {SLICE_MODULES!r} if 'unite_torch.' + m "
        "not in names]\n"
        "assert not missing, missing\n"
        f"lazy = sorted(m for m in sys.modules if m.split('.')[0] in {LAZY!r})\n"
        "assert not lazy, lazy\n"
        "print(len(names))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 40


def test_no_source_names_jax():
    files = list((ROOT / "unite_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (f, n)


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        unite_torch.create_model("clip_b16")
    student = unite_torch.create_model(
        "adaptation_umt_base_patch16_224", device="cpu", num_frames=2,
        tubelet_size=1)
    assert next(student.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_optimizer("adamw", 1e-3, student)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pretrain_train_step(student, student, num_patches=392, frames=2,
                                 mask_ratio=0.8, source_batch_size=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        unite_torch.create_model("vit_base_patch16_224")
    vit = unite_torch.create_model("vit_base_patch16_224", device="cpu",
                                   num_classes=12, all_frames=2,
                                   tubelet_size=1)
    assert next(vit.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_optimizer("adamw", 1e-3, vit, num_layers=1, layer_decay=0.65)
    for build in (make_finetune_train_step, make_eval_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(vit)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_selftrain_step(student, vit, student, num_patches=392,
                            frames=2, mask_ratio=0.8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_selftrain_eval_step(student, vit)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_classifier(SimpleNamespace(nb_classes=12), 768)
    args = stage1_parser().parse_args([])
    args.output_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stage1.main(args)
    # the tools that compute on a device: the card unless asked
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.main(["missing.pth", "fake.mp4", "--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        record_losses.main([str(tmp_path / "losses.jsonl")])
    # the probe times the card's kernels: no CPU run even when asked
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quant_kernel_probe.main()
    with pytest.raises(RuntimeError, match="CUDA only"):
        quant_kernel_probe.main(device="cpu")


def test_create_model_names_the_models():
    assert {"clip_b16", "clip_l14", "clip_l14_336",
            "adaptation_umt_base_patch16_224",
            "adaptation_umt_large_patch16_224",
            "vit_base_patch16_224", "vit_base_patch16_384",
            "vit_large_patch16_224", "vit_large_patch16_384"} <= set(
        unite_torch.list_models())
    with pytest.raises(KeyError, match="available: .*clip_b16"):
        unite_torch.create_model("no_such_model", device="cpu")


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
