"""Record a deterministic stage-1 loss curve for cross-framework parity.

Counterpart of tools/record_losses.py (BASELINE.md's parity protocol):
synthetic videos and the visible-token masks are drawn on the host from
``--seed`` in the JAX tool's order and fed to the step as ``vis_idx``, so
two packages given the same seed and weights train on the same batches.
It runs ``--steps`` stage-1 steps of ``adaptation_umt_base_patch16_224``
against ``clip_b16`` (taps 6-11, bf16, AdamW) and writes one JSON line per
step with its loss and grad norm::

    python -m unite_torch.tools.record_losses out.jsonl --steps 20 \\
        --batch 4 [--student-init b16.pth --clip-init vit_b16.pth] \\
        [--dump-masks m.npz]

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from unite_torch.engines.pretrain_umt import make_pretrain_train_step
from unite_torch.optim.factory import create_optimizer
from unite_torch.train.train_state import TrainState
from unite_torch.utils import torch_import as ti
from unite_torch.utils.device import resolve_device
from unite_torch.utils.registry import create_model

IMG = 224
TAPS = (6, 7, 8, 9, 10, 11)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--mask-ratio", type=float, default=0.8)
    ap.add_argument("--lr", type=float, default=1.5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--student-init", default="")
    ap.add_argument("--clip-init", default="")
    ap.add_argument("--dump-masks", default="",
                    help="also save the drawn masks/videos for the "
                         "reference run")
    return ap


def draw(a, n_patch: int, n_vis: int):
    """Videos [steps, B, T, H, W, C] fp32 and sorted visible indices
    [steps, B, n_vis] int32, drawn from ``--seed`` as the JAX tool draws
    them."""
    rng = np.random.default_rng(a.seed)
    videos = rng.standard_normal(
        (a.steps, a.batch, a.frames, IMG, IMG, 3)).astype(np.float32) * 0.5
    masks = np.stack([
        np.stack([rng.permutation(n_patch)[:n_vis] for _ in range(a.batch)])
        for _ in range(a.steps)]).astype(np.int32)
    masks.sort(axis=-1)  # order-preserving gather like x[~mask]
    return videos, masks


def record(a, device=None) -> list:
    """Run the steps; return the records written, one dict a step."""
    dev = resolve_device(device)
    n_patch = a.frames * (IMG // 16) ** 2
    n_vis = n_patch - int(n_patch * a.mask_ratio)
    videos, masks = draw(a, n_patch, n_vis)
    if a.dump_masks:
        np.savez(a.dump_masks, videos=videos, vis_idx=masks)

    torch.manual_seed(a.seed)
    student = create_model(
        "adaptation_umt_base_patch16_224", device=dev, dtype=torch.bfloat16,
        num_frames=a.frames, tubelet_size=1, clip_return_layers=TAPS)
    teacher = create_model("clip_b16", device=dev, dtype=torch.bfloat16,
                           return_attn=True, return_index=TAPS)
    if a.student_init:
        ti.merge_state(student, ti.wrap_encoder_prefix(
            ti.load_torch_state(a.student_init)))
    if a.clip_init:
        ti.merge_state(teacher, ti.clip_state_for_model(
            ti.load_torch_state(a.clip_init, "model|module|state_dict")))

    opt, _ = create_optimizer("adamw", a.lr, student, weight_decay=0.05,
                              device=dev)
    state = TrainState(student, opt)
    step = make_pretrain_train_step(
        student, teacher, num_patches=n_patch, frames=a.frames,
        mask_ratio=a.mask_ratio, source_batch_size=0,
        clip_loss_data="mixed", device=dev)
    records = []
    with open(a.out, "w") as f:
        for i in range(a.steps):
            m = step(state, {"videos": torch.from_numpy(videos[i]),
                             "vis_idx": torch.from_numpy(masks[i])})
            rec = {"step": i, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"])}
            f.write(json.dumps(rec) + "\n")
            print(rec)
            records.append(rec)
    return records


def main(argv=None, device=None) -> list:
    """The card unless ``device`` says otherwise."""
    return record(parser().parse_args(argv), device)


if __name__ == "__main__":
    main()
