"""The port's optimizers that take statistics over whole tensors under the
scale-out layouts, on gloo CPU ranks (the launcher of
tests/test_torch_port_scaleout_layout.py): lamb (trust ratio), adafactor
(factored row and column means, kept whole on every rank), adamp and sgdp
(channel-wise and layer-wise projections; gradients made orthogonal to the
weights along the one-process run, so that both branches run), novograd
(per-tensor norm, kept whole) and lookahead_adamw (slow weights) under
ZeRO-1, FSDP, TP 2 and TP 2 + ZeRO-1, at world 2 and at world 4.

Each case takes 8 steps of the same gradients as the one-process run
(``--opt`` on the tiny adaptation student of tests/test_torch_port_optim.py,
with layer decay, a frozen decoder and per-step tables) and lands within
1e-5 of each tensor's norm and 1e-3 of each update's norm of it. Its
checkpoint loads back bit for bit into the same layout (state and
parameters, and one more step of both alike) and into one process.

This module imports no JAX: the ranks import it for ``worker``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_port_scaleout_layout import LAYOUTS, _mesh_args, launch

CFG = dict(img_size=64, patch_size=16, encoder_embed_dim=128, encoder_depth=2,
           encoder_num_heads=2, num_frames=8, tubelet_size=1,
           clip_decoder_embed_dim=128, clip_output_dim=64,
           clip_return_layers=(0, 1), use_learnable_pos_emb=True,
           use_cls_token=True)
OPTS = ("lamb", "adafactor", "adamp", "sgdp", "novograd", "lookahead_adamw")
CASE_LAYOUTS = ("zero1", "fsdp", "tp2", "tp2_zero1")
STEPS = 8
LR = np.linspace(2e-3, 5e-4, 24)
WD = np.linspace(0.05, 0.1, 24)
EPS = 1e-6


def build(opt: str, weights: dict):
    """(model, make_optimizer(model)) on the CPU in fp32."""
    from unite_torch.models.adaptation import AdaptationVisionTransformer
    from unite_torch.optim.factory import create_optimizer

    model = AdaptationVisionTransformer(**CFG)
    model.load_state_dict(weights, strict=False)

    def make(m):
        return create_optimizer(
            opt, LR, m, weight_decay=WD, momentum=0.9, eps=EPS,
            trainable=lambda n: not n.startswith("clip_decoder.1."),
            num_layers=2, layer_decay=0.65, device="cpu")[0]

    return model, make


def set_grads(layout, grads: dict) -> None:
    """This rank's piece of each whole gradient into ``.grad`` (an FSDP
    parameter's as a DTensor over its mesh)."""
    from unite_torch.parallel.mesh import is_dtensor

    for n, p in layout.model.named_parameters():
        local = layout.local_param(n, grads[n]).clone()
        if is_dtensor(p):
            from torch.distributed.tensor import DTensor

            local = DTensor.from_local(local, p.device_mesh, p.placements,
                                       run_check=False, shape=p.shape,
                                       stride=p.stride())
        p.grad = local


def full_state(state) -> dict:
    """The whole parameters and optimizer state (collective)."""
    from unite_torch.parallel.mesh import local_tensor

    lay, opt = state.layout, state.optimizer
    named = lay.named_parameters()
    return {"params": {n: lay.full_param(n, local_tensor(p).detach())
                       for n, p in named},
            "opt": {n: {k: (v.clone() if opt.is_whole(k)
                            else lay.full_moment(n, v))
                        for k, v in opt.state[p].items()}
                    for n, p in named if opt.state.get(p)},
            "counts": (opt.count, opt.schedule_offset)}


def same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def job_layouts(payload, tmp):
    """Every (optimizer, layout) case of the payload on this rank; rank 0
    returns each case's whole parameters after the 8 steps and whether its
    checkpoint came back bit for bit."""
    from unite_torch.parallel import mesh as pm
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils import checkpoint as ck

    out = {}
    for name in payload["layouts"]:
        tp, zero1, fsdp = LAYOUTS[name]
        pm.init_distributed(_mesh_args(tp, zero1, fsdp), device="cpu")
        for opt in payload["opts"]:
            grads = payload["grads"][opt if opt in payload["grads"]
                                     else "random"]
            states = []
            for _ in range(2):
                model, make = build(opt, payload["weights"])
                layout = pm.state_layout(model, tp=tp, zero1=zero1,
                                         fsdp=fsdp)
                states.append(TrainState(model, make(model), layout=layout))
            state, again = states
            for g in grads[:STEPS]:
                set_grads(state.layout, g)
                state.apply_gradients()
            full = full_state(state)
            ckpt = tmp / f"{name}-{opt}"
            ck.save_train_state(str(ckpt), 0, state)
            pm.barrier()
            path = str(ckpt / "checkpoint-latest.pth")
            ck.restore_train_state(again, ck.load_checkpoint(path))
            res = {"same_layout": same(full, full_state(again))}
            for st in (state, again):
                set_grads(st.layout, grads[STEPS])
                st.apply_gradients()
            res["continued"] = same(full_state(state)["params"],
                                    full_state(again)["params"])
            if pm.current().rank == 0:
                model, make = build(opt, payload["weights"])
                one = TrainState(model, make(model))
                ck.restore_train_state(one, ck.load_checkpoint(path))
                res["one_process"] = same(full, full_state(one))
                res["params"] = full["params"]
                res["layout"] = state.layout.name
                out[f"{name}/{opt}"] = res
            pm.barrier()
    return out


JOBS = {"layouts": job_layouts}


def worker(job: str, tmp: str) -> None:
    """A launched rank: run ``job`` on the payload, save its result."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    payload = torch.load(tmp / "in.pt", weights_only=False)
    out = JOBS[job](payload, tmp)
    torch.save(out, tmp / f"out{os.environ['RANK']}.pt")


# ------------------------------------------------------------ the tests


def _orthogonal(g, p, over_out: bool):
    """``g`` without its component along ``p``: per input element of a
    Dense weight (a row of its flax kernel), or over the whole tensor."""
    dims = (0,) if over_out else tuple(range(p.dim()))
    coef = (g * p).sum(dims, keepdim=True) / (p * p).sum(dims, keepdim=True)
    return g - coef * p


def _grads(model, rng, projected: bool) -> dict:
    out = {}
    for n, p in model.named_parameters():
        g = torch.from_numpy(
            (0.01 * rng.standard_normal(tuple(p.shape))).astype(np.float32))
        if projected and n.endswith("weight") and p.dim() >= 2:
            if any(k in n for k in ("qkv", "fc1", "patch_embed")):
                g = _orthogonal(g, p.detach(), over_out=True)
            elif any(k in n for k in ("proj", "fc2")):
                g = _orthogonal(g, p.detach(), over_out=False)
        out[n] = g
    return out


def _reference(opt, weights, grads=None, rng=None):
    """The one-process run: its whole parameters after ``STEPS`` steps and
    the gradients it took (drawn along the run when ``grads`` is None)."""
    model, make = build(opt, weights)
    tx = make(model)
    named = dict(model.named_parameters())
    taken = []
    for s in range(STEPS + 1):
        g = grads[s] if grads is not None else _grads(model, rng, True)
        taken.append(g)
        if s == STEPS:
            break
        for n, p in named.items():
            p.grad = g[n].clone()
        tx.step()
    return {n: p.detach().clone() for n, p in named.items()}, taken


def seeded_weights(seed: int = 0) -> dict:
    """Weights ~0.02 and LayerNorm scales ~1, as the JAX parity tests
    draw them (tests/test_torch_port_optim.py::jax_params)."""
    from unite_torch.models.adaptation import AdaptationVisionTransformer

    rng = np.random.default_rng(seed)
    out = {}
    for n, p in AdaptationVisionTransformer(**CFG).named_parameters():
        x = 0.02 * rng.standard_normal(tuple(p.shape))
        if p.dim() == 1 and "norm" in n and n.endswith("weight"):
            x += 1.0
        out[n] = torch.from_numpy(x.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors; the suite's workers contend
    try:
        return _runs()
    finally:
        torch.set_num_threads(n)


def _runs():
    weights = seeded_weights()
    rng = np.random.default_rng(7)
    model, _ = build("lamb", weights)
    grads = {"random": [_grads(model, rng, False)
                        for _ in range(STEPS + 1)]}
    refs = {}
    for opt in ("adamp", "sgdp"):
        refs[opt], grads[opt] = _reference(opt, weights, rng=rng)
    for opt in OPTS:
        if opt not in refs:
            refs[opt], _ = _reference(opt, weights, grads["random"])
    return weights, grads, refs


@pytest.mark.parametrize("world", [2, 4])
def test_whole_tensor_statistics_under_every_layout(tmp_path, runs, world):
    weights, grads, refs = runs
    out = launch(world, "layouts", tmp_path,
                 {"weights": weights, "grads": grads, "opts": OPTS,
                  "layouts": CASE_LAYOUTS},
                 timeout=300, module="tests.test_torch_port_optim_layouts")
    res = out[0]
    assert len(res) == len(OPTS) * len(CASE_LAYOUTS)
    for case, r in res.items():
        opt = case.split("/")[1]
        assert r["same_layout"] and r["continued"] and r["one_process"], (
            case, {k: r[k] for k in ("same_layout", "continued",
                                     "one_process")})
        ref = refs[opt]
        for k, want in ref.items():
            got = r["params"][k]
            assert (got - want).norm() <= 1e-5 * want.norm(), (case, k)
            d_got, d_ref = got - weights[k], want - weights[k]
            assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm() or (
                d_ref.norm() == 0 and d_got.norm() == 0), (case, k)
