"""Optimizer factory: the reference's ``--opt`` names with per-step lr /
weight-decay tables and layer-wise lr decay
(unite_tpu/optim/factory.py::create_optimizer).

Every optimizer is a ``ScheduledOptimizer``: a direction (the subclass's
``_direction``, optax 0.2.6's definition where JAX takes optax's) followed
by the schedule of ``scheduled_optimizer``:

    u = direction(g)  [+ wd_t*p, decay groups, where the decay is decoupled]
    p = p - lr_t*scale*u

with lr_t and wd_t read from their tables at the optimizer's schedule
count, clamped at the last entry. Weight decay takes one of three places,
as in JAX: decoupled (added to the direction's update, as AdamW's: adamw,
radam, lamb, adabelief, lion, adafactor), coupled (torch's L2, added to the
gradient before the direction's statistics: adam, nadam, adadelta, adagrad,
rmsprop, rmsproptf and the SGD family) or inside the direction (AdamP's and
SGDP's projection-modulated decay, NovoGrad's). The schedule count is the
step count (which drives bias corrections and the directions' own
schedules) plus an offset that ``set_schedule_count`` sets when an
optimizer is rebuilt mid-run (the LP-FT switch), as unite_tpu keeps its
ScheduledState count apart from the directions' own counts. Parameters
whose ``.grad`` is None (blocks that never ran under ``clip_only``) and
frozen parameters (scale 0) are skipped: no update and no decay, as torch
AdamW does for a None grad.

AdamW's update is optax's ``scale_by_adam`` and the decoupled decay:

    mu = (1-b1)*g + b1*mu,   nu = b2*nu + (1-b2)*g^2
    u  = (mu/(1-b1^n)) / (sqrt(nu/(1-b2^n)) + eps) + wd_t*p   (decay groups)

With ``mu_dtype`` (--mu_dtype bfloat16; adamw, lamb and nadam, as in JAX)
the first moment is stored in that dtype, in optax's
``scale_by_adam(mu_dtype=)`` order: b1*mu is taken in the stored dtype (as
JAX multiplies a bf16 array by a Python scalar) and promoted, the new
moment summed in fp32, the update taken from the fp32 moment, and only
then the moment cast (round to nearest even) for storage; nu stays fp32.

With ``every_k`` > 1 (--update_freq) the optimizer accumulates gradients
with ``optax.MultiSteps`` semantics: each ``step()`` folds the parameters'
``.grad`` into a running mean (acc += (g - acc) / (n + 1)); every
``every_k``-th call clips that mean once by its global norm
(``optax.clip_by_global_norm``: g * max_norm / norm when norm >= max_norm)
and takes one step from it. The calls in between leave the parameters and
the optimizer's state as they are; ``emitted`` says whether the last call
stepped, which gates the EMA. ``lookahead`` (the ``lookahead_`` prefix)
keeps slow weights, copies of the parameters at their first step; every
k-th emitted step (counted on the schedule count, which JAX's
LookaheadState shares with the tables) they move alpha of the way to the
parameters and the parameters land on them.

Under a layout (``parallel.mesh.Layout.attach``) the optimizer works on
this rank's pieces: ``part(p, t)`` is the piece of a parameter (or of its
gradient) whose update the rank computes, an FSDP shard, a ZeRO-1 slice or
a tensor-parallel shard, and every state tensor shaped like the parameter
has its shape; ``sync`` then broadcasts the ZeRO-1 slices of the stepped
parameters. A statistic over a whole tensor (LAMB's trust ratio,
NovoGrad's squared norm, AdamP's and SGDP's cosines and projections,
Adafactor's row and column means) is summed over the ranks that hold its
pieces (``split``, ``_whole_sums``), so every rank computes it as one
process does; Adafactor's factored rows and columns and NovoGrad's norm
are kept whole on every rank (``whole_keys``). The running mean of
``every_k`` follows the gradients' pieces, and its clip takes the whole
model's norm.

JAX's parameters are flax's: a Dense kernel is [in, out] where the port's
weight is [out, in], and the patch projection is a [kt*kh*kw*C, D] kernel
where the port's is [D, C, kt, kh, kw]. AdamP's and SGDP's channel-wise
projection views a tensor as (rows of its flax dim 0, the rest), and
Adafactor factors its flax shape's two largest dims, so both read such
weights (``dense``) in their flax layout: a row is an input element, summed
over the port's dim 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unite_torch.parallel.mesh import local_tensor, sum_over_groups
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


def dense_kernels(model: torch.nn.Module) -> set:
    """The parameters whose JAX counterpart is a Dense kernel: the weights
    of the linear layers and of the patch projections, and CLIP's packed
    ``in_proj_weight``."""
    from unite_torch.models.layers import Linear, TubeletProjection

    kinds = (torch.nn.Linear, torch.nn.modules.conv._ConvNd, Linear,
             TubeletProjection)
    out = set()
    for mod in model.modules():
        for attr, p in mod.named_parameters(recurse=False):
            if ((attr == "weight" and isinstance(mod, kinds))
                    or attr == "in_proj_weight"):
                out.add(p)
    return out


def _table(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.float64))


class ScheduledOptimizer(torch.optim.Optimizer):
    """A direction whose lr and weight decay follow per-step tables,
    stepping once every ``every_k`` calls from the clipped mean of their
    gradients. Subclasses supply ``_direction``: the update of this rank's
    pieces, before the decoupled decay and the lr."""

    decay = "decoupled"  # or "coupled" (L2 into the gradient), "inside"
    mu_key: Optional[str] = None  # the state that --mu_dtype stores
    whole_keys: Tuple[str, ...] = ()  # state kept whole on every rank

    def __init__(self, param_groups, lr_table, wd_table, every_k: int = 1,
                 clip_grad: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None,
                 lookahead: Optional[Tuple[int, float]] = None,
                 dense=()):
        super().__init__(param_groups, {"lr_scale": 1.0, "decay": True})
        if mu_dtype is not None and self.mu_key is None:
            raise ValueError(f"{type(self).__name__} keeps no first moment "
                             "in --mu_dtype")
        self.lr_table, self.wd_table = _table(lr_table), _table(wd_table)
        self.mu_dtype = mu_dtype  # None: the parameters' dtype
        self.count = 0  # drives bias corrections
        self.schedule_offset = 0  # tables index count + schedule_offset
        self.every_k, self.clip_grad = int(every_k), clip_grad
        self.mini_step = 0  # position in the accumulation window
        self.acc: Dict[torch.Tensor, torch.Tensor] = {}
        self.lookahead = lookahead  # (k, alpha) or None
        self.dense = set(dense)  # weights read in their flax layout
        self.part = None  # (param, tensor) -> this rank's piece
        self.split = None  # param -> (dim, positions, length, group) | None
        self.sync = None  # (stepped params) -> None, after each step
        self._positions: Dict[torch.Tensor, torch.Tensor] = {}

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
            g = local_tensor(p.grad)
            acc = self.acc.get(p)
            if acc is None:
                acc = self.acc[p] = torch.zeros_like(g)
            acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step:
            return False
        grads = [self.acc.pop(p) for p in params]
        if self.clip_grad is not None:
            norm = global_grad_norm(grads, params)
            keep = norm < self.clip_grad
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_grad))
        for p, g in zip(params, grads):
            if local_tensor(p.grad) is p.grad:
                p.grad = g
            else:  # a DTensor's shard
                local_tensor(p.grad).copy_(g)
        return True

    @torch.no_grad()
    def step(self, closure=None):
        if self.every_k > 1 and not self._accumulate():
            return
        i = self.count + self.schedule_offset
        lr_t = float(self.lr_table[min(i, len(self.lr_table) - 1)])
        wd_t = float(self.wd_table[min(i, len(self.wd_table) - 1)])
        part = self.part or (lambda p, t: t)
        groups = []
        for group in self.param_groups:
            live = [p for p in group["params"] if p.grad is not None]
            if group["lr_scale"] != 0.0 and live:
                groups.append((group, live))
        stepped = [p for _, live in groups for p in live]
        params = [part(p, p) for p in stepped]
        if self.lookahead is not None:
            for p, piece in zip(stepped, params):
                if "slow" not in self.state[p]:
                    self.state[p]["slow"] = piece.detach().clone()
        if stepped:
            grads = [part(p, p.grad) for p in stepped]
            decay = [g["decay"] for g, live in groups for _ in live]
            if self.decay == "coupled":
                grads = [torch.add(g, x, alpha=wd_t) if d else g
                         for g, x, d in zip(grads, params, decay)]
            upd = self._direction(stepped, params, grads, decay, wd_t)
            o = 0
            for group, live in groups:
                ps, us = params[o:o + len(live)], upd[o:o + len(live)]
                o += len(live)
                if self.decay == "decoupled" and group["decay"]:
                    torch._foreach_add_(us, ps, alpha=wd_t)
                torch._foreach_add_(ps, us,
                                    alpha=-(lr_t * group["lr_scale"]))
        if self.lookahead is not None and (i + 1) % self.lookahead[0] == 0:
            stepped = self._sync_slow(part)
        if self.sync is not None:
            self.sync(stepped)
        self.count += 1

    def _sync_slow(self, part) -> list:
        """Lookahead's sync: slow += alpha * (fast - slow), fast = slow,
        over every parameter that keeps slow weights; returns them."""
        alpha = self.lookahead[1]
        synced = [p for g in self.param_groups for p in g["params"]
                  if "slow" in self.state.get(p, {})]
        if synced:
            fast = [part(p, p) for p in synced]
            slow = [self.state[p]["slow"] for p in synced]
            torch._foreach_add_(slow, torch._foreach_sub(fast, slow),
                                alpha=alpha)
            torch._foreach_copy_(fast, slow)
        return synced

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        raise NotImplementedError

    def _init(self, live, params, **makers) -> None:
        """State ``key`` = ``make(piece)`` for each parameter lacking it."""
        for p, piece in zip(live, params):
            st = self.state[p]
            for key, make in makers.items():
                if key not in st:
                    st[key] = make(piece)

    def _get(self, live, key) -> list:
        return [self.state[p][key] for p in live]

    # ----- statistics over whole tensors

    def _split(self, p):
        return self.split(p) if self.split is not None else None

    def _pos(self, p, pos, device):
        t = self._positions.get(p)
        if t is None or t.device != device:
            t = self._positions[p] = pos.to(device)
        return t

    def _full_shape(self, p, piece) -> List[int]:
        shape = list(piece.shape)
        sp = self._split(p)
        if sp is not None:
            shape[sp[0]] = sp[2]
        return shape

    def _whole_sums(self, owners, stats, dims) -> list:
        """``stats[i]``, the piece of ``owners[i]`` summed over ``dims[i]``
        (keepdim; None: over every dim), as the same sum over the whole
        tensor, on every rank: a piece's entries are placed at their
        positions where the split dim is kept, and the pieces' sums added
        over the group that holds them, one ``all_reduce`` a group."""
        out, todo, groups = list(stats), [], []
        for i, (p, s, d) in enumerate(zip(owners, stats, dims)):
            sp = self._split(p)
            if sp is None:
                continue
            dim, pos, n, group = sp
            if d is not None and dim not in d:
                shape = list(s.shape)
                shape[dim] = n
                s = s.new_zeros(shape).index_copy_(
                    dim, self._pos(p, pos, s.device), s)
            out[i] = s
            todo.append(i)
            groups.append(group)
        if todo:
            for i, s in zip(todo, sum_over_groups([out[i] for i in todo],
                                                  groups)):
                out[i] = s
        return out

    def _local(self, p, stat, dims):
        """This rank's entries of a whole statistic summed over ``dims``."""
        sp = self._split(p)
        if sp is None or dims is None or sp[0] in dims:
            return stat
        return stat.index_select(sp[0], self._pos(p, sp[1], stat.device))

    def _sq_sums(self, live, xs) -> list:
        """The sum of squares of each whole tensor, from this rank's pieces
        (a dot product: the CPU's fp32 norms lose precision over millions
        of elements, which LAMB's trust ratio passes to every element)."""
        sq = [torch.dot(x.reshape(-1), x.reshape(-1)) for x in xs]
        return self._whole_sums(live, sq, [None] * len(live))

    def moment_dtype(self, key: str, param: torch.Tensor) -> torch.dtype:
        """The dtype a state tensor ``key`` is kept in."""
        if key == self.mu_key and self.mu_dtype is not None:
            return self.mu_dtype
        return param.dtype

    def is_whole(self, key: str) -> bool:
        """Whether state ``key`` is kept whole on every rank (else it is
        shaped like this rank's piece of its parameter)."""
        return key in self.whole_keys


class ScheduledAdamW(ScheduledOptimizer):
    """AdamW (optax ``scale_by_adam``, decoupled decay)."""

    mu_key = "mu"
    nesterov = False

    def __init__(self, param_groups, lr_table, wd_table,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 **kw):
        super().__init__(param_groups, lr_table, wd_table, **kw)
        self.betas, self.eps = betas, eps

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        return self._adam(live, params, grads)

    def _adam(self, live, params, grads) -> list:
        b1, b2 = self.betas
        n = self.count + 1
        bc1, bc2 = 1.0 - b1 ** n, 1.0 - b2 ** n
        for p, piece in zip(live, params):
            st = self.state[p]
            if "mu" not in st:
                st["mu"] = torch.zeros_like(
                    piece, dtype=self.mu_dtype or p.dtype)
                st["nu"] = torch.zeros_like(piece)
        mus = self._get(live, "mu")
        nus = self._get(live, "nu")
        # optax's (1-b1)*g + b1*mu: b1*mu in the stored moment's dtype
        # (b1, a weak-typed scalar there, rounded to it first), the sum
        # in the parameters' dtype
        if self.mu_dtype is None:
            new_mus = mus
            torch._foreach_mul_(new_mus, b1)
        else:
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            new_mus = [m.to(p.dtype) for m, p in zip(
                torch._foreach_mul(mus, b1_mu), params)]
        torch._foreach_add_(new_mus, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        if self.nesterov:
            # optax's nesterov: b1*mu/(1-b1^(n+1)) + (1-b1)*g/(1-b1^n)
            upd = torch._foreach_div(new_mus, 1.0 - b1 ** (n + 1))
            torch._foreach_mul_(upd, b1)
            torch._foreach_add_(upd, torch._foreach_div(grads, bc1),
                                alpha=1.0 - b1)
        else:
            upd = torch._foreach_div(new_mus, bc1)
        torch._foreach_div_(upd, denom)
        if self.mu_dtype is not None:
            torch._foreach_copy_(mus, new_mus)
        return upd


class Adam(ScheduledAdamW):
    """Adam with torch's L2 decay; its moments stay fp32 under
    --mu_dtype, as JAX's."""

    decay = "coupled"
    mu_key = None


class NAdam(ScheduledAdamW):
    """optax ``scale_by_adam(nesterov=True)`` with torch's L2 decay."""

    decay = "coupled"
    nesterov = True


class Lamb(ScheduledAdamW):
    """optax ``scale_by_adam`` then ``scale_by_trust_ratio`` (||p|| / ||u||,
    1 where either is 0), before the decoupled decay."""

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        upd = self._adam(live, params, grads)
        pn = torch.stack(self._sq_sums(live, params)).sqrt()
        un = torch.stack(self._sq_sums(live, upd)).sqrt()
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                            pn / un)
        for u, r in zip(upd, ratio.unbind()):
            u.mul_(r)
        return upd


class RAdam(ScheduledAdamW):
    """optax ``scale_by_radam`` (threshold 5): the bias-corrected momentum
    until the variance is tractable, then Adam's update times the
    rectification r; fp32 moments."""

    mu_key = None

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        b1, b2 = self.betas
        n = self.count + 1
        self._init(live, params, mu=torch.zeros_like, nu=torch.zeros_like)
        mus, nus = self._get(live, "mu"), self._get(live, "nu")
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        f32 = np.float32
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        # fp32, as a jitted JAX step computes it: the subtraction of two
        # near-equal values amplifies any other rounding of b2**n
        b2t = f32(b2) ** f32(n)
        ro = f32(ro_inf) - f32(2 * n) * b2t / (f32(1.0) - b2t)
        upd = torch._foreach_div(mus, 1.0 - b1 ** n)
        if ro >= 5.0:
            r = float(np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
            denom = torch._foreach_div(nus, 1.0 - b2 ** n)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_mul_(upd, r)
            torch._foreach_div_(upd, denom)
        return upd


class AdaBelief(ScheduledAdamW):
    """optax ``scale_by_belief``: the second moment of g - mu, plus
    eps_root = 1e-16 a step."""

    mu_key = None

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        b1, b2 = self.betas
        n = self.count + 1
        self._init(live, params, mu=torch.zeros_like, nu=torch.zeros_like)
        mus, nus = self._get(live, "mu"), self._get(live, "nu")
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        err = torch._foreach_sub(grads, mus)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, err, err, value=1.0 - b2)
        torch._foreach_add_(nus, 1e-16)
        denom = torch._foreach_div(nus, 1.0 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, 1.0 - b1 ** n)
        torch._foreach_div_(upd, denom)
        return upd


class Lion(ScheduledAdamW):
    """optax ``scale_by_lion``: sign((1-b1)*g + b1*mu), then mu = (1-b2)*g +
    b2*mu."""

    mu_key = None

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        b1, b2 = self.betas
        self._init(live, params, mu=torch.zeros_like)
        mus = self._get(live, "mu")
        upd = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(upd, mus, alpha=b1)
        upd = torch._foreach_sign(upd)
        torch._foreach_mul_(mus, b2)
        torch._foreach_add_(mus, grads, alpha=1.0 - b2)
        return upd


class Adafactor(ScheduledOptimizer):
    """optax ``scale_by_factored_rms()``: a tensor whose flax shape's second
    largest dim is >= 128 keeps the means of g^2 + 1e-30 over its largest
    dim (``v_row``) and its second largest (``v_col``), whole; the rest keep
    an elementwise ``v``; decay 1 - (n)^-0.8 at step n."""

    whole_keys = ("v_row", "v_col")

    def _factored(self, p, shape):
        """(torch dims of the flax dim averaged into v_row, of the one
        averaged into v_col, their sizes), or None."""
        if p in self.dense:  # flax [prod(in), out]
            fshape = (math.prod(shape[1:]), shape[0])
            fdims = (tuple(range(1, len(shape))), (0,))
        else:
            fshape = tuple(shape)
            fdims = tuple((d,) for d in range(len(shape)))
        if len(fshape) < 2:
            return None
        order = np.argsort(fshape)
        if fshape[order[-2]] < 128:
            return None
        d1, d0 = int(order[-2]), int(order[-1])
        return fdims[d0], fdims[d1], fshape[d0], fshape[d1]

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        t = np.float32(self.count + 1)
        rate = float(np.float32(1.0) - t ** np.float32(-0.8))
        plans, owners, stats, dims = [], [], [], []
        for p, piece, g in zip(live, params, grads):
            f = self._factored(p, self._full_shape(p, piece))
            g2 = g * g + 1e-30
            plans.append((f, g2))
            if f is not None:
                owners += [p, p]
                stats += [g2.sum(f[0], keepdim=True),
                          g2.sum(f[1], keepdim=True)]
                dims += [f[0], f[1]]
        sums = iter(self._whole_sums(owners, stats, dims))
        upd = []
        for p, piece, g, (f, g2) in zip(live, params, grads, plans):
            st = self.state[p]
            if f is None:
                v = st.get("v")
                v = (torch.zeros_like(piece) if v is None else v)
                v.mul_(rate).add_(g2, alpha=1.0 - rate)
                st["v"] = v
                upd.append(g * v.pow(-0.5))
                continue
            t0, t1, n0, n1 = f
            row, col = next(sums) / n0, next(sums) / n1
            v_row = st.get("v_row", torch.zeros_like(row))
            v_col = st.get("v_col", torch.zeros_like(col))
            v_row = st["v_row"] = v_row * rate + row * (1.0 - rate)
            v_col = st["v_col"] = v_col * rate + col * (1.0 - rate)
            row_f = (v_row / v_row.mean(t1, keepdim=True)).pow(-0.5)
            col_f = v_col.pow(-0.5)
            upd.append(g * self._local(p, row_f, t0)
                       * self._local(p, col_f, t1))
        return upd


class Adagrad(ScheduledOptimizer):
    """optax ``scale_by_rss(0, eps)`` with torch's L2 decay."""

    decay = "coupled"

    def __init__(self, param_groups, lr_table, wd_table, eps: float = 1e-8,
                 **kw):
        super().__init__(param_groups, lr_table, wd_table, **kw)
        self.eps = eps

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        self._init(live, params, sum=torch.zeros_like)
        sums = self._get(live, "sum")
        torch._foreach_addcmul_(sums, grads, grads)
        return [torch.where(s > 0, torch.rsqrt(s + self.eps),
                            torch.zeros_like(s)) * g
                for s, g in zip(sums, grads)]


class Adadelta(ScheduledOptimizer):
    """optax ``scale_by_adadelta(rho=0.9, eps)`` with torch's L2 decay."""

    decay = "coupled"
    rho = 0.9

    def __init__(self, param_groups, lr_table, wd_table, eps: float = 1e-8,
                 **kw):
        super().__init__(param_groups, lr_table, wd_table, **kw)
        self.eps = eps

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        rho = self.rho
        self._init(live, params, e_g=torch.zeros_like, e_x=torch.zeros_like)
        e_g, e_x = self._get(live, "e_g"), self._get(live, "e_x")
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, grads, grads, value=1.0 - rho)
        upd = torch._foreach_add(e_x, self.eps)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(e_g, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, upd, upd, value=1.0 - rho)
        return upd


class SGD(ScheduledOptimizer):
    """optax ``trace(decay=momentum, nesterov)`` with torch's L2 decay:
    buf = g + m*buf, the update buf (heavy ball) or g + m*buf
    (Nesterov). The update is the state itself where it is buf: a coupled
    direction's update is only read."""

    decay = "coupled"

    def __init__(self, param_groups, lr_table, wd_table,
                 momentum: float = 0.9, nesterov: bool = False, **kw):
        super().__init__(param_groups, lr_table, wd_table, **kw)
        self.momentum, self.nesterov = momentum, nesterov

    def _trace(self, live, params, grads) -> list:
        self._init(live, params, trace=torch.zeros_like)
        tr = self._get(live, "trace")
        torch._foreach_mul_(tr, self.momentum)
        torch._foreach_add_(tr, grads)
        if self.nesterov:
            return torch._foreach_add(grads, tr, alpha=self.momentum)
        return tr

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        return self._trace(live, params, grads)


class RMSprop(SGD):
    """optax ``scale_by_rms(decay=0.9)`` then ``trace(decay=momentum)``,
    torch's L2 decay: eps outside the square root and nu from 0
    (rmsprop), or inside and nu from 1 (rmsproptf)."""

    def __init__(self, param_groups, lr_table, wd_table, eps: float = 1e-8,
                 momentum: float = 0.9, tf: bool = False, **kw):
        super().__init__(param_groups, lr_table, wd_table, momentum=momentum,
                         **kw)
        self.eps, self.tf = eps, tf

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        self._init(live, params, nu=(torch.ones_like if self.tf
                                     else torch.zeros_like))
        nus = self._get(live, "nu")
        torch._foreach_mul_(nus, 0.9)
        torch._foreach_addcmul_(nus, grads, grads, value=0.1)
        if self.tf:
            den = torch._foreach_add(nus, self.eps)
            torch._foreach_sqrt_(den)
        else:
            den = torch._foreach_sqrt(nus)
            torch._foreach_add_(den, self.eps)
        return self._trace(live, params, torch._foreach_div(grads, den))


class _Projected(ScheduledOptimizer):
    """AdamP's and SGDP's tangent-space projection
    (unite_tpu/optim/factory.py::_projection), on whole tensors: where the
    gradient is nearly orthogonal to a weight of ndim >= 2, channel-wise
    (the rows of its flax layout) and else layer-wise, the update loses its
    component along the weight and the decay is scaled by ``wd_ratio``."""

    decay = "inside"
    delta = 0.1

    def _rows(self, p, x) -> tuple:
        """The dims a flax row sums over: the port's dim 0 for a Dense
        kernel (a row is an input element), the rest for other tensors."""
        return (0,) if p in self.dense else tuple(range(1, x.dim()))

    def _project(self, live, params, grads, upd, wd_ratio: float, eps: float):
        """(projected updates, each tensor's decay ratio)."""
        ratios: list = [1.0] * len(live)
        idx = [i for i, x in enumerate(params) if x.dim() >= 2]
        owners, stats, dims = [], [], []
        for i in idx:
            p, x, g = live[i], params[i], grads[i]
            r = self._rows(p, x)
            owners += [p] * 3
            stats += [(g * x).sum(r, keepdim=True),
                      (g * g).sum(r, keepdim=True),
                      (x * x).sum(r, keepdim=True)]
            dims += [r] * 3
        a = self._whole_sums(owners, stats, dims)
        plans, owners, stats, dims = [], [], [], []
        for k, i in enumerate(idx):
            p, x, u = live[i], params[i], upd[i]
            r = self._rows(p, x)
            gp, gg, pp = a[3 * k:3 * k + 3]
            shape = self._full_shape(p, x)
            row_len = math.prod(shape[d] for d in r)
            cos = gp.abs() / (gg.sqrt() * pp.sqrt() + eps)
            ok_c = cos.max() < self.delta / math.sqrt(row_len)
            gp_l, gg_l, pp_l = gp.sum(), gg.sum(), pp.sum()
            cos_l = gp_l.abs() / (gg_l.sqrt() * pp_l.sqrt() + eps)
            ok_l = cos_l < self.delta / math.sqrt(math.prod(shape))
            pn_c = x / (self._local(p, pp, r).sqrt() + eps)
            pn_l = x / (pp_l.sqrt() + eps)
            plans.append((pn_c, pn_l, ok_c, ok_l))
            owners += [p, p]
            stats += [(pn_c * u).sum(r, keepdim=True), (pn_l * u).sum()]
            dims += [r, None]
        b = self._whole_sums(owners, stats, dims)
        upd = list(upd)
        for k, i in enumerate(idx):
            p, x, u = live[i], params[i], upd[i]
            pn_c, pn_l, ok_c, ok_l = plans[k]
            proj_c = u - pn_c * self._local(p, b[2 * k], self._rows(p, x))
            proj_l = u - pn_l * b[2 * k + 1]
            upd[i] = torch.where(ok_c, proj_c, torch.where(ok_l, proj_l, u))
            ratios[i] = torch.where(ok_c | ok_l, wd_ratio, 1.0)
        return upd, ratios


class AdamP(_Projected):
    """AdamP (unite_tpu ``adamp_direction``: Nesterov Adam, the projection
    with wd_ratio 0.01, decay wd_t * ratio * p inside the direction)."""

    def __init__(self, param_groups, lr_table, wd_table,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 **kw):
        super().__init__(param_groups, lr_table, wd_table, **kw)
        self.betas, self.eps = betas, eps

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        b1, b2 = self.betas
        n = self.count + 1
        self._init(live, params, mu=torch.zeros_like, nu=torch.zeros_like)
        mus, nus = self._get(live, "mu"), self._get(live, "nu")
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nus, 1.0 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        num = torch._foreach_mul(mus, b1)
        torch._foreach_add_(num, grads, alpha=1.0 - b1)
        torch._foreach_div_(num, denom)
        torch._foreach_div_(num, 1.0 - b1 ** n)
        upd, ratios = self._project(live, params, grads, num, 0.01, self.eps)
        return [u + x * (wd_t * r) if d else u
                for u, x, r, d in zip(upd, params, ratios, decay)]


class SGDP(_Projected):
    """SGDP (unite_tpu ``sgdp_direction``: Nesterov momentum, the projection
    with wd_ratio 0.1, decay wd_t * ratio / (1 - momentum) * p)."""

    def __init__(self, param_groups, lr_table, wd_table,
                 momentum: float = 0.9, eps: float = 1e-8, **kw):
        super().__init__(param_groups, lr_table, wd_table, **kw)
        self.momentum, self.eps = momentum, eps

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        m = self.momentum
        self._init(live, params, buf=torch.zeros_like)
        bufs = self._get(live, "buf")
        torch._foreach_mul_(bufs, m)
        torch._foreach_add_(bufs, grads)
        d_p = torch._foreach_add(grads, bufs, alpha=m)
        upd, ratios = self._project(live, params, grads, d_p, 0.1, self.eps)
        return [u + x * (wd_t * r / (1.0 - m)) if d else u
                for u, x, r, d in zip(upd, params, ratios, decay)]


class NovoGrad(ScheduledOptimizer):
    """NovoGrad (unite_tpu ``novograd_direction``): one fp32 second moment
    a tensor, nu = ||g||^2 at the first step, then b2*nu + (1-b2)*||g||^2;
    mu = b1*mu + g/(sqrt(nu) + eps) + wd_t*p, the update mu."""

    decay = "inside"
    whole_keys = ("nu",)

    def __init__(self, param_groups, lr_table, wd_table,
                 betas: Tuple[float, float] = (0.95, 0.98), eps: float = 1e-8,
                 **kw):
        super().__init__(param_groups, lr_table, wd_table, **kw)
        self.betas, self.eps = betas, eps

    def _direction(self, live, params, grads, decay, wd_t) -> list:
        b1, b2 = self.betas
        sums = self._sq_sums(live, grads)
        self._init(live, params, mu=torch.zeros_like)
        for p, sq in zip(live, sums):
            st = self.state[p]
            st["nu"] = (sq if self.count == 0 or "nu" not in st
                        else st["nu"] * b2 + sq * (1.0 - b2))
        nus = self._get(live, "nu")
        upd = [g / (v.sqrt() + self.eps) for g, v in zip(grads, nus)]
        for u, x, d in zip(upd, params, decay):
            if d:
                u.add_(x, alpha=wd_t)
        mus = self._get(live, "mu")
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, upd)
        return mus


OPT_NAMES = ("adamw", "adam", "nadam", "radam", "lamb", "adabelief",
             "adagrad", "adadelta", "rmsprop", "rmsproptf", "lion", "sgd",
             "momentum", "nesterov", "adamp", "sgdp", "adafactor", "novograd",
             "nvnovograd")
SUPPORTED_OPTS = (" ".join(OPT_NAMES)
                  + " (+ fused* aliases, lookahead_* prefix)")


def create_optimizer(opt: str, lr, model: torch.nn.Module,
                     weight_decay=0.0, momentum: float = 0.9,
                     betas: Optional[Tuple[float, float]] = None,
                     eps: float = 1e-8,
                     skip_list: Sequence[str] = DEFAULT_SKIP_LIST,
                     trainable: Optional[Callable[[str], bool]] = None,
                     num_layers: Optional[int] = None,
                     layer_decay: Optional[float] = None,
                     mu_dtype: Optional[torch.dtype] = None,
                     device=None):
    """Build the optimizer ``opt`` (a name of ``SUPPORTED_OPTS``: ``fused``
    anywhere in it is dropped, a ``lookahead_`` prefix wraps the rest) for
    ``model``'s parameters, which must lie on ``device`` (CUDA when None).
    ``lr`` and ``weight_decay`` are per-step tables or constants;
    ``layer_decay`` < 1 with the model's ``num_layers`` scales each group's
    lr by layer; ``mu_dtype`` stores the first moment of adamw, lamb and
    nadam in that dtype (None: fp32). ``betas`` None: (0.95, 0.98) for
    novograd and nvnovograd, else (0.9, 0.999). ``adahessian`` raises
    NotImplementedError, an unknown name ValueError. Returns (optimizer,
    groups)."""
    name = opt.lower().replace("fused", "").strip("_")
    ahead = name.startswith("lookahead_")
    if ahead:
        name = name.split("_", 1)[1]
    if name == "adahessian":
        raise NotImplementedError(
            "adahessian needs a second-order (Hutchinson) backward pass and "
            "is not supported; pick one of: " + SUPPORTED_OPTS)
    if name not in OPT_NAMES:
        raise ValueError(f"unsupported optimizer {opt!r}; supported: "
                         f"{SUPPORTED_OPTS}")
    if betas is None:
        betas = ((0.95, 0.98) if name in ("novograd", "nvnovograd")
                 else (0.9, 0.999))
    betas = tuple(betas)
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
    adam = dict(betas=betas, eps=eps)
    nesterov = name != "momentum" and momentum > 0
    cls, args = {
        "adamw": (ScheduledAdamW, dict(mu_dtype=mu_dtype, **adam)),
        "adam": (Adam, adam),
        "nadam": (NAdam, dict(mu_dtype=mu_dtype, **adam)),
        "radam": (RAdam, adam),
        "lamb": (Lamb, dict(mu_dtype=mu_dtype, **adam)),
        "adabelief": (AdaBelief, adam),
        "lion": (Lion, dict(betas=betas)),
        "adafactor": (Adafactor, {}),
        "adagrad": (Adagrad, dict(eps=eps)),
        "adadelta": (Adadelta, dict(eps=eps)),
        "rmsprop": (RMSprop, dict(eps=eps, momentum=momentum)),
        "rmsproptf": (RMSprop, dict(eps=eps, momentum=momentum, tf=True)),
        "sgd": (SGD, dict(momentum=momentum, nesterov=nesterov)),
        "momentum": (SGD, dict(momentum=momentum)),
        "nesterov": (SGD, dict(momentum=momentum, nesterov=nesterov)),
        "adamp": (AdamP, adam),
        "sgdp": (SGDP, dict(momentum=momentum, eps=eps)),
        "novograd": (NovoGrad, adam),
        "nvnovograd": (NovoGrad, adam),
    }[name]
    tx = cls(torch_groups, lr, weight_decay,
             lookahead=(6, 0.5) if ahead else None,
             dense=dense_kernels(model), **args)
    return tx, groups


def set_schedule_count(opt, step: int) -> None:
    """Continue the lr / wd tables of a freshly built optimizer (the LP-FT
    switch) from optimizer step ``step``, leaving its bias-correction count
    where it is (unite_tpu/optim/factory.py::set_schedule_count). The
    directions' decay tables (AdamP, SGDP, NovoGrad) and lookahead's sync
    count follow the schedule count too; bias corrections, NovoGrad's
    first step and Adafactor's decay follow the step count, and restart
    with a rebuilt optimizer, as in JAX."""
    opt.schedule_offset = int(step) - int(opt.count)
