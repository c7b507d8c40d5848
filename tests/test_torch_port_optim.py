"""unite_torch's optimizer family (``unite_torch.optim.factory``) against
unite_tpu's ``create_optimizer``, on the CPU in fp32.

Every name JAX's factory builds (the 18 directions beside adamw, the
``fused*`` aliases, ``lookahead_*`` and ``--mu_dtype bfloat16`` where JAX
applies it) takes the same 8 seeded gradients on the parameters of a tiny
adaptation student carried across by the flax bridge: Dense kernels, the
patch projection, a learnable ``pos_embed`` and a ``cls_token``, wide enough
(128) that Adafactor factors the kernels and ``pos_embed``. Layer decay
0.65, a frozen clip decoder and per-step lr and wd tables. After every step
each tensor is within 1e-5 of its norm of JAX's and its update within 1e-3
of the update's norm (the bar of tests/test_torch_port_step.py, Adam's eps
1e-6). The harness here is shared with tests/test_torch_port_optim_*.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unite_tpu.models import adaptation as jad
from unite_tpu.optim import factory as jfactory
from unite_tpu.train import common as jcommon
from unite_torch.models import adaptation as tad
from unite_torch.optim import factory as tfactory
from unite_torch.train import common as tcommon
from unite_torch.utils.flax_bridge import flax_to_state_dict

CFG = dict(img_size=64, patch_size=16, encoder_embed_dim=128, encoder_depth=2,
           encoder_num_heads=2, num_frames=8, tubelet_size=1,
           clip_decoder_embed_dim=128, clip_output_dim=64,
           clip_return_layers=(0, 1), use_learnable_pos_emb=True,
           use_cls_token=True)
DEPTH = 2
STEPS = 8
EPS = 1e-6
FROZEN = "clip_decoder_1"
FROZEN_PORT = "clip_decoder.1."
LR = np.linspace(2e-3, 5e-4, 24)
WD = np.linspace(0.05, 0.1, 24)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: its tensors are small, and
    the suite runs several workers at once, whose thread pools contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_params(seed: int = 0):
    """A flax param tree of ``CFG`` with seeded values (weights ~0.02,
    LayerNorm scales ~1), no forward pass needed; the same tree object on
    every call, which its callers only read."""
    sj = jad.AdaptationVisionTransformer(**CFG)
    shapes = jax.eval_shape(
        lambda x, idx: sj.init(jax.random.PRNGKey(0), x, idx, False),
        jnp.zeros((1, 8, 64, 64, 3)), jnp.zeros((1, 64), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = 0.02 * rng.standard_normal(s.shape)
        if path[-1].key == "scale":
            x += 1.0
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_mask(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, _: path[0].key != FROZEN, params)


def port_model(params):
    model = tad.AdaptationVisionTransformer(**CFG)
    state = flax_to_state_dict(params)
    model.load_state_dict(state, strict=False)
    for n, p in model.named_parameters():
        assert torch.equal(p, state[n]), n
    return model


def port_trainable(name: str) -> bool:
    return not name.startswith(FROZEN_PORT)


def random_grads(params, rng):
    return jax.tree.map(
        lambda x: (0.01 * rng.standard_normal(x.shape)).astype(np.float32),
        params)


def _orthogonal(g, p, rows: bool):
    """``g`` without its component along ``p``: per row of the (p.shape[0],
    -1) view, or over the whole tensor."""
    gv = g.reshape(p.shape[0] if rows else 1, -1).astype(np.float64)
    pv = np.asarray(p, np.float64).reshape(gv.shape)
    gv = gv - ((gv * pv).sum(1, keepdims=True)
               / (pv * pv).sum(1, keepdims=True)) * pv
    return gv.reshape(g.shape).astype(np.float32)


def projected_grads(params, rng):
    """Random gradients, made orthogonal to some weights so that both of
    AdamP's and SGDP's projections run: row by row (its channel branch) for
    qkv, fc1 and the patch projection, as a whole (the layer-wise branch)
    for proj and fc2."""
    def leaf(path, p):
        g = (0.01 * rng.standard_normal(p.shape)).astype(np.float32)
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] != "kernel":
            return g
        if any(k in keys for k in ("qkv", "fc1", "patch_embed")):
            return _orthogonal(g, p, rows=True)
        if any(k in keys for k in ("proj", "fc2")):
            return _orthogonal(g, p, rows=False)
        return g

    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_tx(opt, params, mu_dtype=None, update_freq=1, clip=None):
    tx, _ = jfactory.create_optimizer(
        opt, lr=LR, params=params, weight_decay=WD, momentum=0.9, eps=EPS,
        num_layers=DEPTH, layer_decay=0.65, trainable_mask=jax_mask(params),
        mu_dtype=mu_dtype)
    return jcommon.wrap_update_freq(tx, update_freq, clip)


def port_tx(opt, model, mu_dtype=None, update_freq=1, clip=None):
    tx, _ = tfactory.create_optimizer(
        opt, LR, model, weight_decay=WD, momentum=0.9, eps=EPS,
        trainable=port_trainable, num_layers=DEPTH, layer_decay=0.65,
        mu_dtype=mu_dtype, device="cpu")
    return tcommon.wrap_update_freq(tx, update_freq, clip)


def set_grads(model, grads) -> None:
    named = dict(model.named_parameters())
    for n, g in flax_to_state_dict(grads).items():
        named[n].grad = g


def check_close(model, jp, prev, what: str) -> dict:
    """Every tensor within 1e-5 of its norm of JAX's, its update since
    ``prev`` within 1e-3 of the update's norm; the frozen decoder still.
    Returns the port's parameters."""
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jp))
    got = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert set(ref) == set(got)
    for k in ref:
        assert (got[k] - ref[k]).norm() <= 1e-5 * ref[k].norm(), (what, k)
        d_got, d_ref = got[k] - prev[k], ref[k] - prev[k]
        if not port_trainable(k):
            assert d_ref.abs().max() == 0 and d_got.abs().max() == 0, k
        else:
            assert d_ref.norm() > 0, (what, k)
            assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm(), (what, k)
    return got


def run_pair(opt, mu_dtype=None, grads_fn=random_grads, update_freq=1,
             clip=None, steps=STEPS, rebuild_at=None, seed=1, jit=True):
    """``steps`` optimizer steps (``update_freq`` micro-batches each) of
    JAX's and the port's optimizer from the same parameters and gradients,
    checked after every step; with ``rebuild_at`` both optimizers are built
    anew at that step and continue their tables from it (the LP-FT switch).
    ``jit`` False runs JAX's update eagerly. Returns (JAX params, port
    model, port optimizer)."""
    params = jax_params()
    jp = jax.tree.map(jnp.asarray, params)
    model = port_model(params)
    jdt = {None: None, "bfloat16": jnp.bfloat16}[mu_dtype]
    tdt = {None: None, "bfloat16": torch.bfloat16}[mu_dtype]
    tx = jax_tx(opt, params, jdt, update_freq, clip)
    jstate = tx.init(jp)
    wrap = jax.jit if jit else (lambda f: f)
    jupdate = wrap(tx.update)
    ttx = port_tx(opt, model, tdt, update_freq, clip)
    rng = np.random.default_rng(seed)
    prev = {n: p.detach().clone() for n, p in model.named_parameters()}
    for s in range(steps):
        if s == rebuild_at:
            tx = jax_tx(opt, params, jdt, update_freq, clip)
            jstate = jfactory.set_schedule_count(tx.init(jp), s)
            jupdate = wrap(tx.update)
            ttx = port_tx(opt, model, tdt, update_freq, clip)
            tfactory.set_schedule_count(ttx, s)
        for _ in range(update_freq):
            g = grads_fn(jax.tree.map(np.asarray, jp), rng)
            upd, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
            jp = jax.block_until_ready(optax.apply_updates(jp, upd))
            set_grads(model, g)
            ttx.step()
        prev = check_close(model, jp, prev, f"{opt} step {s}")
    return jp, model, ttx


NAMES = ("adamw", "adam", "nadam", "radam", "lamb", "adabelief", "adagrad",
         "adadelta", "rmsprop", "rmsproptf", "lion", "sgd", "momentum",
         "nesterov", "adamp", "sgdp", "adafactor", "novograd", "nvnovograd")


@pytest.mark.parametrize("opt", NAMES)
def test_trajectory_matches_jax(opt):
    run_pair(opt, grads_fn=(projected_grads if opt in ("adamp", "sgdp")
                            else random_grads))


ALIASES = ("fusedadam", "fusedlamb", "fusednovograd", "fused_sgd",
           "fusedmomentum")


@pytest.mark.parametrize("opt", ALIASES + ("lookahead_adamw",
                                           "lookahead_sgd"))
def test_aliases_and_lookahead_match_jax(opt):
    """8 steps: lookahead syncs at step 6 and steps on after it."""
    run_pair(opt)
