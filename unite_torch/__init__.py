"""UNITE in PyTorch for NVIDIA Hopper: the port of ``unite_tpu``.

Models, ops and engines mirror ``unite_tpu``'s layout and names. Entry
points place everything on CUDA unless the caller passes ``device="cpu"``;
attention runs through hand-written CUDA kernels (``csrc/``) on the card and
through their plain PyTorch versions on the CPU."""

from unite_torch.utils.registry import create_model, list_models, register_model

__all__ = ["create_model", "list_models", "register_model"]
