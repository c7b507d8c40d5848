"""Train state: the model, its optimizer, the step counter and an optional
EMA of the parameters (unite_tpu/train/train_state.py). Gradients live on
the parameters' ``.grad``, as PyTorch keeps them; a parameter whose
``.grad`` is None took no part in the step and is left alone by the
optimizer. ``layout`` (``parallel.mesh.state_layout``) says how the state
lies over the ranks: the EMA follows the parameters' pieces, and the steps
call ``net`` (the model, or its DDP wrapper)."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from unite_torch.parallel.mesh import (Layout, is_dtensor, local_tensor,
                                      sum_over_groups)


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer,
                 ema_decay: Optional[float] = None,
                 layout: Optional[Layout] = None):
        """``ema_decay`` keeps ``ema_params`` (name -> tensor), a copy of
        every parameter (this rank's piece of it) at creation (timm
        ModelEma, run_stage2.py:587-593). ``layout``: one process when
        None; the optimizer is attached to it."""
        self.step = 0
        self.model = model
        self.layout = layout if layout is not None else Layout(model)
        self.optimizer = self.layout.attach(optimizer)
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay:
            self.ema_params = {n: local_tensor(p).detach().clone()
                               for n, p in model.named_parameters()}

    @property
    def net(self) -> torch.nn.Module:
        """The module a train step calls: the model, or its wrapper."""
        return self.layout.net

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
                torch._foreach_add_(ema, [local_tensor(named[n]).detach()
                                          for n in self.ema_params],
                                    alpha=1.0 - d)


def _shard_group(p):
    """The group a parameter's pieces are spread over (None: whole on this
    rank): an FSDP DTensor's mesh, a tensor-parallel shard's model group."""
    if is_dtensor(p):
        return p.device_mesh.get_group()
    return getattr(p, "tp_group", None)


def global_grad_norm(grads: Iterable[torch.Tensor],
                     params: Optional[Iterable[torch.Tensor]] = None
                     ) -> torch.Tensor:
    """L2 norm over all gradients, in fp32. With ``params`` (one a
    gradient), the squares of sharded gradients (FSDP, tensor parallel) are
    summed over their group, so every rank gets the whole model's norm."""
    grads = list(grads)
    groups = ([None] * len(grads) if params is None
              else [_shard_group(p) for p in params])
    whole, sharded = [], {}
    for g, group in zip(grads, groups):
        sq = local_tensor(g).float().square().sum()
        if group is None:
            whole.append(sq)
        else:
            sharded.setdefault(id(group), (group, []))[1].append(sq)
    sq = (torch.stack(whole).sum() if whole
          else torch.zeros((), device=local_tensor(grads[0]).device))
    for part in sum_over_groups(
            [torch.stack(parts).sum() for _, parts in sharded.values()],
            [group for group, _ in sharded.values()]):
        sq = sq + part
    return sq.sqrt()


def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: Optional[float]) -> torch.Tensor:
    """torch ``clip_grad_norm_`` semantics, in place on ``.grad``; returns
    the pre-clip norm (also when ``max_norm`` is None), of the whole model
    under every layout."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    norm = global_grad_norm(grads, params)
    if max_norm is not None:
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            local_tensor(g).mul_(scale.to(g.dtype))
    return norm
