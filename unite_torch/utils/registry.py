"""Model registry: string name -> model factory (unite_tpu/utils/registry.py).

``create_model`` builds the module with its parameters in fp32 and its
compute in ``dtype``, and places it on ``device`` (CUDA when None; on
"meta" it is built there, shapes only)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from unite_torch.utils.device import resolve_device

_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    """Decorator registering ``fn`` under its function name."""
    name = fn.__name__
    if name in _MODEL_REGISTRY:
        raise ValueError(f"model {name!r} already registered")
    _MODEL_REGISTRY[name] = fn
    return fn


def create_model(name: str, *, device=None, dtype=torch.float32, **kwargs):
    """Instantiate a registered model by name on ``device``."""
    import unite_torch.models  # noqa: F401  (registration side effects)

    if name not in _MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_MODEL_REGISTRY)}")
    dev = resolve_device(device)
    if dev.type == "meta":  # shapes only: nothing is allocated or initialized
        with dev:
            return _MODEL_REGISTRY[name](dtype=dtype, **kwargs)
    return _MODEL_REGISTRY[name](dtype=dtype, **kwargs).to(dev)


def list_models():
    import unite_torch.models  # noqa: F401

    return sorted(_MODEL_REGISTRY)
