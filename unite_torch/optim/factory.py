"""Optimizer factory: AdamW with per-step lr / weight-decay tables and
layer-wise lr decay (unite_tpu/optim/factory.py, the ``adamw`` path of
``create_optimizer``).

The update is optax's ``scale_by_adam`` followed by the decoupled decay of
``scheduled_optimizer``:

    mu = b1*mu + (1-b1)*g,   nu = b2*nu + (1-b2)*g^2
    u  = (mu/(1-b1^n)) / (sqrt(nu/(1-b2^n)) + eps) + wd_t*p   (decay groups)
    p  = p - lr_t*scale*u

with lr_t and wd_t read from their tables at the optimizer's schedule
count, clamped at the last entry. The schedule count is the step count
(which drives the bias correction) plus an offset that
``set_schedule_count`` sets when an optimizer is rebuilt mid-run (the
LP-FT switch), as unite_tpu keeps its ScheduledState count apart from
Adam's. Parameters whose ``.grad`` is None (blocks that never ran under
``clip_only``) and frozen parameters (scale 0) are skipped: no update and
no decay, as torch AdamW does for a None grad.

With ``every_k`` > 1 (--update_freq) the optimizer accumulates gradients
with ``optax.MultiSteps`` semantics: each ``step()`` folds the parameters'
``.grad`` into a running mean (acc += (g - acc) / (n + 1)); every
``every_k``-th call clips that mean once by its global norm
(``optax.clip_by_global_norm``: g * max_norm / norm when norm >= max_norm)
and takes one AdamW step from it. The calls in between leave the parameters
and the moments as they are; ``emitted`` says whether the last call stepped,
which gates the EMA.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from unite_torch.train.train_state import global_grad_norm
from unite_torch.utils.device import resolve_device

DEFAULT_SKIP_LIST = ("pos_embed", "cls_token", "mask_token", "clip_pos_embed")


def get_num_layer_for_vit(name: str, num_max_layer: int) -> int:
    """Layer id of a parameter for layer-wise decay, from its dotted name
    (optim_factory.py:44-62 of the reference, with the JAX package's extra
    names); a leading ``encoder.`` (adaptation students) or
    ``transformer.`` (CLIP's resblocks) is skipped."""
    parts = name.split(".")
    if parts[0] in ("encoder", "transformer"):
        parts = parts[1:]
    head = parts[0]
    if head in ("cls_token", "mask_token", "pos_embed", "class_embedding",
                "positional_embedding", "temporal_positional_embedding"):
        return 0
    if head.startswith("patch_embed") or head.startswith("conv1"):
        return 0
    if head.startswith("rel_pos_bias"):
        return num_max_layer - 1
    if head in ("blocks", "resblocks"):
        return int(parts[1]) + 1
    return num_max_layer - 1


def layer_decay_scales(layer_decay: float, num_layers: int) -> list:
    """decay**(num_layers+1-i) for i in 0..num_layers+1 (run_stage2.py:616)."""
    return [layer_decay ** (num_layers + 1 - i) for i in range(num_layers + 2)]


def param_group_metadata(named_params, weight_decay: float,
                         skip_list: Sequence[str] = DEFAULT_SKIP_LIST,
                         trainable: Optional[Callable[[str], bool]] = None,
                         num_layers: Optional[int] = None,
                         layer_decay: Optional[float] = None):
    """name -> {"weight_decay", "lr_scale", "params": [names]} groups:
    no decay for tensors of ndim <= 1, for ``bias`` and for names in the
    skip list. With ``layer_decay`` < 1 the groups are
    ``layer_{id}_{decay|no_decay}`` with scale ``layer_decay_scales[id]``.
    A parameter for which ``trainable(name)`` is False goes to the "frozen"
    group with scale 0."""
    scales = None
    if layer_decay is not None and layer_decay < 1.0:
        if num_layers is None:
            raise ValueError("layer_decay needs num_layers")
        scales = layer_decay_scales(layer_decay, num_layers)
    groups: Dict[str, dict] = {}
    for name, p in named_params:
        parts = name.split(".")
        no_decay = (p.ndim <= 1 or parts[-1] == "bias"
                    or parts[-1] in skip_list or parts[0] in skip_list)
        kind = "no_decay" if no_decay else "decay"
        scale, gname = 1.0, kind
        if scales is not None:
            layer_id = get_num_layer_for_vit(name, len(scales))
            scale, gname = scales[layer_id], f"layer_{layer_id}_{kind}"
        if trainable is not None and not trainable(name):
            scale, gname = 0.0, "frozen"
        groups.setdefault(gname, {"weight_decay": 0.0 if no_decay
                                  else weight_decay,
                                  "lr_scale": scale, "params": []})
        groups[gname]["params"].append(name)
    return groups


def _table(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.float64))


class ScheduledAdamW(torch.optim.Optimizer):
    """AdamW whose lr and weight decay follow per-step tables, stepping once
    every ``every_k`` calls from the clipped mean of their gradients."""

    def __init__(self, param_groups, lr_table, wd_table,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 every_k: int = 1, clip_grad: Optional[float] = None):
        super().__init__(param_groups, {"lr_scale": 1.0, "decay": True})
        self.lr_table, self.wd_table = _table(lr_table), _table(wd_table)
        self.betas, self.eps = betas, eps
        self.count = 0  # drives bias correction
        self.schedule_offset = 0  # tables index count + schedule_offset
        self.every_k, self.clip_grad = int(every_k), clip_grad
        self.mini_step = 0  # position in the accumulation window
        self.acc: Dict[torch.Tensor, torch.Tensor] = {}

    @property
    def emitted(self) -> bool:
        return self.mini_step == 0

    def _accumulate(self) -> bool:
        """Fold ``.grad`` into the running mean; at the window's end put the
        clipped mean back into ``.grad`` and return True."""
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        n = self.mini_step
        for p in params:
            acc = self.acc.get(p)
            if acc is None:
                acc = self.acc[p] = torch.zeros_like(p.grad)
            acc.add_((p.grad - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step:
            return False
        grads = [self.acc.pop(p) for p in params]
        if self.clip_grad is not None:
            norm = global_grad_norm(grads)
            keep = norm < self.clip_grad
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_grad))
        for p, g in zip(params, grads):
            p.grad = g
        return True

    @torch.no_grad()
    def step(self, closure=None):
        if self.every_k > 1 and not self._accumulate():
            return
        b1, b2 = self.betas
        i = self.count + self.schedule_offset
        lr_t = float(self.lr_table[min(i, len(self.lr_table) - 1)])
        wd_t = float(self.wd_table[min(i, len(self.wd_table) - 1)])
        n = self.count + 1
        bc1, bc2 = 1.0 - b1 ** n, 1.0 - b2 ** n
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if group["lr_scale"] == 0.0 or not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, denom)
            if group["decay"]:
                torch._foreach_add_(upd, params, alpha=wd_t)
            torch._foreach_add_(params, upd, alpha=-(lr_t * group["lr_scale"]))
        self.count += 1


def create_optimizer(opt: str, lr, model: torch.nn.Module,
                     weight_decay=0.0,
                     betas: Optional[Tuple[float, float]] = None,
                     eps: float = 1e-8,
                     skip_list: Sequence[str] = DEFAULT_SKIP_LIST,
                     trainable: Optional[Callable[[str], bool]] = None,
                     num_layers: Optional[int] = None,
                     layer_decay: Optional[float] = None,
                     device=None):
    """Build the optimizer for ``model``'s parameters, which must lie on
    ``device`` (CUDA when None). ``lr`` and ``weight_decay`` are per-step
    tables or constants; ``layer_decay`` < 1 with the model's
    ``num_layers`` scales each group's lr by layer. Returns (optimizer,
    groups)."""
    name = opt.lower()
    if name != "adamw":
        raise NotImplementedError(
            f"optimizer {opt!r} is not ported yet (ROADMAP queue 1, item 8); "
            "the port has 'adamw'")
    dev = resolve_device(device)
    named = list(model.named_parameters())
    for pname, p in named:
        if p.device.type != dev.type:
            raise ValueError(f"parameter {pname} is on {p.device}, "
                             f"optimizer asked for {dev}")
    wd_value = float(np.max(_table(weight_decay)))
    groups = param_group_metadata(named, wd_value, skip_list, trainable,
                                  num_layers, layer_decay)
    by_name = dict(named)
    torch_groups = [{"params": [by_name[n] for n in g["params"]],
                     "lr_scale": g["lr_scale"],
                     "decay": g["weight_decay"] > 0.0}
                    for g in groups.values()]
    tx = ScheduledAdamW(torch_groups, lr, weight_decay,
                        betas=betas or (0.9, 0.999), eps=eps)
    return tx, groups


def set_schedule_count(opt, step: int) -> None:
    """Continue the lr / wd tables of a freshly built optimizer (the LP-FT
    switch) from optimizer step ``step``, leaving its bias-correction count
    where it is (unite_tpu/optim/factory.py::set_schedule_count)."""
    opt.schedule_offset = int(step) - int(opt.count)
