"""Train state: the model, its optimizer, the step counter and an optional
EMA of the parameters (unite_tpu/train/train_state.py). Gradients live on
the parameters' ``.grad``, as PyTorch keeps them; a parameter whose
``.grad`` is None took no part in the step and is left alone by the
optimizer."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer,
                 ema_decay: Optional[float] = None):
        """``ema_decay`` keeps ``ema_params`` (name -> tensor), a copy of
        every parameter at creation (timm ModelEma, run_stage2.py:587-593)."""
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay:
            self.ema_params = {n: p.detach().clone()
                               for n, p in model.named_parameters()}

    def apply_gradients(self, ema_decay: Optional[float] = None):
        """One optimizer step from the parameters' current ``.grad``, then,
        when the state keeps an EMA and ``ema_decay`` is given,
        ema = decay * ema + (1 - decay) * param over every parameter. Under
        gradient accumulation (the optimizer's ``every_k``) ``step`` counts
        micro-batches and the EMA moves only where the optimizer stepped
        (timm's ModelEma updates once an optimizer step)."""
        self.optimizer.step()
        self.step += 1
        if (self.ema_params is not None and ema_decay is not None
                and self.optimizer.emitted):
            named = dict(self.model.named_parameters())
            ema = list(self.ema_params.values())
            # the decay as fp32, and 1 - decay from it, as the JAX step has
            d = float(torch.tensor(ema_decay, dtype=torch.float32))
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [named[n].detach()
                                          for n in self.ema_params],
                                    alpha=1.0 - d)


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
