"""Export the port's weights and checkpoints as reference-format PyTorch
state dicts (unite_tpu/utils/torch_export.py).

The port's parameters already carry the reference checkpoints' names
(``utils.flax_bridge`` maps flax trees onto them), so an export is a key
check and a writer: ``export_state`` gives fp32 CPU tensors under the
reference keys and raises on any key a reference student lacks;
``export_checkpoint`` turns a checkpoint of the port (``utils.checkpoint``)
into ``{'model': state_dict, 'epoch': ...}``, the payload the reference's
loaders read, with a stage-3 combined checkpoint's classifier head under
``src_classifier``.
"""

from __future__ import annotations

from typing import Dict

import torch

from unite_torch.utils.flax_bridge import student_key_ok


def export_state(model_or_state) -> Dict[str, torch.Tensor]:
    """A model (its ``state_dict``) or a state dict -> {reference key:
    fp32 CPU tensor}; raises on a key outside the reference layout."""
    state = (model_or_state.state_dict()
             if isinstance(model_or_state, torch.nn.Module)
             else model_or_state)
    bad = sorted(k for k in state if not student_key_ok(k))
    if bad:
        raise ValueError(f"keys outside the reference layout: {bad}")
    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in state.items()}


def _strip(state: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def export_checkpoint(src_path: str, dst_path: str) -> str:
    """Write the port's checkpoint ``src_path`` as a reference-format
    ``.pth`` at ``dst_path``: ``{'model': ..., 'epoch': ...}``. A stage-3
    combined checkpoint (``model.*`` and ``classifier.*`` keys) exports
    the student under ``model`` and the head as ``src_classifier``."""
    from unite_torch.utils import checkpoint as ck

    payload = ck.load_checkpoint(src_path)
    model = payload["model"]
    extra = {}
    student, head = _strip(model, "model."), _strip(model, "classifier.")
    if student and head and len(student) + len(head) == len(model):
        extra["src_classifier"] = export_state(head)
        model = student
    out = {"model": export_state(model), "epoch": payload.get("epoch", 0),
           **extra}
    torch.save(out, dst_path)
    return dst_path
