"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take CUDA, and with no CUDA device they raise instead of
carrying on quietly on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
