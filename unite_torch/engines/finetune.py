"""Stage-2 finetune engine: the train step, the eval step and the multi-view
test merge (unite_tpu/engines/finetune.py).

One train step: normalize -> ViT forward and backward -> cross-entropy (or
soft-target CE on injected ``soft_targets``) -> global grad norm (and
optional clip) -> AdamW with layer-wise decay -> optional EMA. Every
parameter gets its gradient, frozen blocks included, as in the JAX step,
which differentiates all params: the frozen blocks count in ``grad_norm``
and only their update is 0 (the optimizer's "frozen" group). At 1568 tokens
the attention of all 12 blocks runs forward through K3 and backward through
K4.

The epoch loops, logging and checkpoints belong to the stage-2 entry
(``unite_torch/train/run_stage2.py``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from unite_torch.engines.losses import (
    accuracy_topk,
    cross_entropy,
    soft_target_cross_entropy,
)
from unite_torch.ops.normalize import normalize_videos
from unite_torch.train.train_state import TrainState, clip_by_global_norm
from unite_torch.utils.device import resolve_device


def make_finetune_train_step(model: torch.nn.Module, mixup=None,
                             label_smoothing: float = 0.0,
                             clip_grad: Optional[float] = None,
                             ema_decay: Optional[float] = None,
                             device=None) -> Callable:
    """Build ``train_step(state, batch, generator=None) -> metrics``.

    ``state.model`` is ``model``, moved to ``device`` (CUDA when None), and
    ``state`` is updated in place. ``batch`` holds uint8 (or normalized)
    ``videos`` [B, T, H, W, C] and int ``labels`` [B]; ``soft_targets``
    [B, classes], when present, are taken as the targets of already mixed
    videos (the injection hook of the JAX step). Metrics are 0-d tensors on
    the device: ``loss``, the pre-clip ``grad_norm`` and, without soft
    targets, ``class_acc`` and ``acc5`` as fractions."""
    if mixup is not None:
        raise NotImplementedError(
            "device-side mixup (ops/mixup.py) is not ported yet (ROADMAP "
            "queue 1, item 4); inject batch['soft_targets'] instead")
    dev = resolve_device(device)
    model.to(dev)

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None) -> Dict:
        videos = normalize_videos(batch["videos"].to(dev, non_blocking=True))
        labels = batch["labels"].to(dev)
        soft = batch.get("soft_targets")
        net = state.model
        net.train()
        logits = net(videos, generator)
        if soft is not None:
            loss = soft_target_cross_entropy(logits, soft.to(dev))
        else:
            loss = cross_entropy(logits, labels, label_smoothing)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = clip_by_global_norm(net.parameters(), clip_grad)
        state.apply_gradients(ema_decay=ema_decay)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        if soft is None:  # the reference logs no class_acc under mixup
            acc1, acc5 = accuracy_topk(logits.detach(), labels)
            metrics["class_acc"] = acc1 / 100.0
            metrics["acc5"] = acc5 / 100.0
        return metrics

    return train_step


def make_eval_step(model: torch.nn.Module, use_ema: bool = False,
                   input_transform: Optional[Callable] = None,
                   device=None) -> Callable:
    """Validation step: ``eval_step(state, batch)`` -> softmax ``probs``
    (fp32), ``labels``, ``acc1`` and ``acc5`` in percent, and ``loss``.
    ``use_ema`` runs the state's EMA parameters; ``input_transform``
    replaces the uint8 normalize. Runs without gradients, so K3 writes no
    lse."""
    dev = resolve_device(device)
    model.to(dev)
    transform = input_transform or normalize_videos

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict) -> Dict:
        net = state.model.eval()
        x = transform(batch["videos"].to(dev, non_blocking=True))
        labels = batch["labels"].to(dev)
        if use_ema and state.ema_params is not None:
            logits = torch.func.functional_call(net, state.ema_params, (x,))
        else:
            logits = net(x)
        acc1, acc5 = accuracy_topk(logits, labels)
        return {"probs": torch.softmax(logits.float(), dim=-1),
                "labels": labels, "acc1": acc1, "acc5": acc5,
                "loss": cross_entropy(logits, labels)}

    return eval_step


# ---------------------------------------------------------------------------
# Multi-view test + merge (engine_for_finetuning.py:241-351)
# ---------------------------------------------------------------------------


def write_preds_file(path: str,
                     records: List[Tuple[str, np.ndarray, int, int, int]]):
    """Append per-view predictions: (video_id, probs, label, chunk, crop),
    one line per view, so ``merge`` can de-duplicate repeated views."""
    with open(path, "a") as f:
        for vid, probs, label, chunk_nb, split_nb in records:
            probs_str = ",".join(f"{p:.8f}" for p in np.asarray(probs))
            f.write(f"{vid}\t{probs_str}\t{label}\t{chunk_nb}\t{split_nb}\n")


def merge(eval_path: str, num_tasks: int) -> Tuple[float, float]:
    """Combine the per-process view files ``{rank}.txt`` -> per-video mean
    softmax over its unique (chunk, crop) views -> top-1 / top-5 in
    percent."""
    videos: Dict[str, Dict] = {}
    for rank in range(num_tasks):
        path = os.path.join(eval_path, f"{rank}.txt")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                vid, probs_str, label, chunk_nb, split_nb = \
                    line.strip().split("\t")
                entry = videos.setdefault(vid, {"label": int(label),
                                                "views": {}})
                entry["views"][(chunk_nb, split_nb)] = np.array(
                    probs_str.split(","), dtype=np.float64)
    if not videos:
        return 0.0, 0.0
    top1 = top5 = 0
    for entry in videos.values():
        feat = np.mean(list(entry["views"].values()), axis=0)
        order = np.argsort(-feat)
        top1 += int(order[0] == entry["label"])
        top5 += int(entry["label"] in order[:5])
    n = len(videos)
    return 100.0 * top1 / n, 100.0 * top5 / n
