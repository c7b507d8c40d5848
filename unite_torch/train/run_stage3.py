"""Stage 3 (collaborative self-training): the classifier, the trainable
mask and the optimizer.

Counterpart of unite_tpu/train/run_stage3.py:51-55 (``build_classifier``)
and :189-218 (the trainable mask and ``create_optimizer``), as functions of
an args-like namespace with the stage-3 CLI's names
(configs/stage3_config.yaml). The ``main`` entry (the target stream, the
classifier-head import, the zero-shot teacher from the CLI's text
artifacts, the epoch loop, validation and the multi-view test) is not
ported yet (ROADMAP queue 1, item 5); the steps it runs are
``unite_torch.engines.selftrain``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from unite_torch.models.layers import Linear
from unite_torch.optim.factory import create_optimizer
from unite_torch.utils.device import resolve_device


def build_classifier(args, embed_dim: int, device=None) -> Linear:
    """The source classifier Linear(embed_dim, nb_classes), computing in
    fp32 (run_stage3.py:1191), on ``device`` (CUDA when None)."""
    if getattr(args, "src_classifier_type", "linear") != "linear":
        raise NotImplementedError(args.src_classifier_type)
    return Linear(embed_dim, args.nb_classes, dtype=torch.float32).to(
        resolve_device(device))


def combine(student: nn.Module, classifier: nn.Module) -> nn.ModuleDict:
    """One module over both, the JAX state's {"model", "classifier"} tree:
    parameter names ``model.encoder...`` and ``classifier.weight``."""
    return nn.ModuleDict({"model": student, "classifier": classifier})


def trainable_mask(args, model: nn.ModuleDict) -> Dict[str, bool]:
    """Parameter name -> trainable. The reference registers only the
    encoder with its optimizer, so the classifier is frozen: it keeps its
    gradient (it counts in the grad norm) and is not updated. The whole
    student trains, its CLIP decoders too unless --freeze_clip_decoders."""
    freeze_dec = getattr(args, "freeze_clip_decoders", False)

    def decide(name: str) -> bool:
        parts = name.split(".")
        if parts[0] == "classifier":
            return False
        return not (freeze_dec and parts[1] == "clip_decoder")

    return {name: decide(name) for name, _ in model.named_parameters()}


def build_optimizer(args, model: nn.ModuleDict, lr, weight_decay,
                    device=None):
    """AdamW over the combined module with the stage-3 mask: ``lr`` and
    ``weight_decay`` are per-step tables or constants. Returns (optimizer,
    groups)."""
    mask = trainable_mask(args, model)
    return create_optimizer(args.opt, lr, model, weight_decay=weight_decay,
                            betas=tuple(args.opt_betas), eps=args.opt_eps,
                            trainable=mask.__getitem__, device=device)
