"""Stage 2 (supervised finetune): the model and the freeze policy.

Counterpart of unite_tpu/train/run_stage2.py:38-59 (``build_model``) and
:94-123 (``trainable_mask``), as functions of an args-like namespace with
the stage-2 CLI's names (configs/stage2_config.yaml). The ``main`` entry
(datasets, checkpoint import, epoch loop, validation and the multi-view
test) waits for slice B's args, config, checkpoint and data path
(ROADMAP queue 1, items 9-10); the step it runs is
``unite_torch.engines.finetune``.
"""

from __future__ import annotations

from typing import Dict

import torch

from unite_torch.utils.registry import create_model

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(args) -> torch.dtype:
    """--compute_dtype: bf16 unless the namespace says float32."""
    return _DTYPES[getattr(args, "compute_dtype", "bfloat16") or "bfloat16"]


def build_model(args, device=None):
    """The classification ViT as the stage-2 entry builds it, on ``device``
    (CUDA when None)."""
    if getattr(args, "use_checkpoint", False):
        raise NotImplementedError(
            "activation checkpointing (--use_checkpoint) is not ported yet "
            "(ROADMAP queue 1, item 11)")
    return create_model(
        args.model, device=device, dtype=compute_dtype(args),
        num_classes=args.nb_classes, all_frames=args.num_frames,
        tubelet_size=args.tubelet_size, fc_drop_rate=args.fc_drop_rate,
        drop_rate=args.drop, attn_drop_rate=args.attn_drop_rate,
        drop_path_rate=args.drop_path,
        use_learnable_pos_emb=args.use_learnable_pos_emb,
        use_mean_pooling=args.use_mean_pooling, init_scale=args.init_scale,
        classifier_type=args.head_type,
        classifier_hidden_dim=args.head_hidden_dim)


def trainable_mask(args, model: torch.nn.Module,
                   lp_phase: bool = False) -> Dict[str, bool]:
    """Freeze policies (run_stage2.py:711-746): head only, frozen block ids,
    the patch embedding, or LP-FT's first phase (blocks 0-8 and the patch
    embedding). Parameter name -> trainable; frozen parameters keep their
    gradients (they count in the grad norm), only their update is 0."""
    frozen_blocks = set()
    if getattr(args, "frozen_layers", ""):
        frozen_blocks = {int(x) for x in str(args.frozen_layers).split(",")
                         if str(x).strip() != ""}
    if lp_phase:
        frozen_blocks = set(range(9))

    def decide(name: str) -> bool:
        parts = name.split(".")
        if args.train_head_only:
            # head + final norms (reference matches 'head'/'norm.weight')
            return parts[0] in ("head", "fc_norm", "norm")
        if parts[0] == "blocks" and int(parts[1]) in frozen_blocks:
            return False
        if (args.freeze_patch_embedding or lp_phase) and \
                parts[0] == "patch_embed":
            return False
        return True

    return {name: decide(name) for name, _ in model.named_parameters()}
