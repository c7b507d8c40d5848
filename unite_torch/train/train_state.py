"""Train state: the student, its optimizer and the step counter
(unite_tpu/train/train_state.py). Gradients live on the parameters'
``.grad``, as PyTorch keeps them; a parameter whose ``.grad`` is None took
no part in the step and is left alone by the optimizer."""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer):
        self.step = 0
        self.model = model
        self.optimizer = optimizer

    def apply_gradients(self):
        """One optimizer step from the parameters' current ``.grad``."""
        self.optimizer.step()
        self.step += 1


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all gradients, in fp32."""
    grads = list(grads)
    sq = torch.stack([g.float().square().sum() for g in grads]).sum()
    return sq.sqrt()


def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: Optional[float]) -> torch.Tensor:
    """torch ``clip_grad_norm_`` semantics, in place on ``.grad``; returns
    the pre-clip norm (also when ``max_norm`` is None)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_grad_norm(grads)
    if max_norm is not None:
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return norm
