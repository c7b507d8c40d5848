"""The port's optimizer family composed with the rest of the training stack,
against unite_tpu on the CPU (the harness of tests/test_torch_port_optim.py):

* ``--mu_dtype bfloat16``: a bf16 first moment for adamw, lamb and nadam,
  fp32 moments for the rest, as JAX applies it;
* ``--update_freq 2`` with a clip, against JAX's
  ``MultiSteps(chain(clip, tx))``;
* the LP-FT switch: both optimizers rebuilt mid-run and continued from the
  global step with ``set_schedule_count`` (the tables, AdamP's and
  NovoGrad's decay tables, lookahead's sync count);
* every direction's state through a checkpoint, bit for bit, on one
  process;
* the names JAX refuses, refused alike.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_optim import (NAMES, jax_params,  # noqa: F401
                                         one_thread, port_model, port_tx,
                                         projected_grads, random_grads,
                                         run_pair, set_grads)
from unite_tpu.optim import factory as jfactory
from unite_torch.optim import factory as tfactory
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck


@pytest.mark.parametrize("opt", ("adamw", "lamb", "nadam"))
def test_bf16_first_moment_matches_jax(opt):
    # eagerly, as tests/test_torch_port_recipe.py holds the bf16 moment to
    # optax: a jitted XLA graph on the CPU rounds b1*mu differently from
    # the eager one, which the port follows
    _, model, tx = run_pair(opt, mu_dtype="bfloat16", jit=False)
    for p in model.parameters():
        if tx.state.get(p):
            assert tx.state[p]["mu"].dtype == torch.bfloat16
            assert tx.state[p]["nu"].dtype == torch.float32


@pytest.mark.parametrize("opt", ("adam", "radam", "lion", "adabelief"))
def test_mu_dtype_leaves_other_moments_fp32(opt):
    """JAX gives --mu_dtype to adamw, lamb and nadam only: the others step
    as they do without it, bit for bit."""
    params = jax_params()
    rng = np.random.default_rng(3)
    grads = [random_grads(params, rng) for _ in range(2)]
    out = []
    for dt in (None, torch.bfloat16):
        model = port_model(params)
        tx = port_tx(opt, model, dt)
        for g in grads:
            set_grads(model, g)
            tx.step()
        assert all(v.dtype == torch.float32 for s in tx.state.values()
                   for v in s.values())
        out.append({n: p.detach().clone()
                    for n, p in model.named_parameters()})
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


@pytest.mark.parametrize("opt", ("lamb", "adafactor", "sgdp", "novograd",
                                 "lookahead_adamw"))
def test_update_freq_with_clip_matches_multisteps(opt):
    run_pair(opt, update_freq=2, clip=3.0,
             grads_fn=projected_grads if opt == "sgdp" else random_grads)


@pytest.mark.parametrize("opt", ("adamw", "adamp", "novograd", "sgd",
                                 "lookahead_adamw"))
def test_lp_ft_rebuild_continues_the_schedule(opt):
    _, _, tx = run_pair(opt, rebuild_at=3,
                        grads_fn=projected_grads if opt == "adamp"
                        else random_grads)
    assert tx.count == 5 and tx.schedule_offset == 3


def _train_state(opt, params):
    model = port_model(params)
    return TrainState(model, port_tx(opt, model))


@pytest.mark.parametrize("opt", NAMES + ("lookahead_sgd",))
def test_checkpoint_carries_every_state_key(opt, tmp_path):
    """7 steps, a checkpoint, a fresh state restored from it, then 2 more
    steps of both: the state and the parameters bit for bit."""
    params = jax_params()
    rng = np.random.default_rng(4)
    grads = [projected_grads(params, rng) for _ in range(9)]
    state = _train_state(opt, params)
    for g in grads[:7]:
        set_grads(state.model, g)
        state.apply_gradients()
    ck.save_train_state(str(tmp_path), 0, state)
    again = _train_state(opt, params)
    ck.restore_train_state(again, ck.load_checkpoint(
        str(tmp_path / "checkpoint-latest.pth")))
    names = dict(state.model.named_parameters())
    names2 = dict(again.model.named_parameters())
    for n, p in names.items():
        s1, s2 = state.optimizer.state.get(p, {}), again.optimizer.state.get(
            names2[n], {})
        assert set(s1) == set(s2), n
        for k in s1:
            assert s1[k].dtype == s2[k].dtype and torch.equal(s1[k], s2[k])
    assert (again.optimizer.count, again.step) == (7, 7)
    for g in grads[7:]:
        for st in (state, again):
            set_grads(st.model, g)
            st.apply_gradients()
    for n, p in names.items():
        assert torch.equal(p, names2[n]), n


def test_refused_names_raise_as_in_jax():
    params = jax_params()
    model = port_model(params)
    for opt, err in (("adahessian", NotImplementedError),
                     ("fusedadahessian", NotImplementedError),
                     ("lookahead_adahessian", NotImplementedError),
                     ("adamx", ValueError), ("lookahead_nope", ValueError)):
        with pytest.raises(err):
            jfactory.create_optimizer(opt, 1e-3, params)
        with pytest.raises(err, match="adamw adam nadam"):
            tfactory.create_optimizer(opt, 1e-3, model, device="cpu")


def test_default_betas_follow_the_direction():
    model = port_model(jax_params())
    for opt, betas in (("novograd", (0.95, 0.98)),
                       ("fusednovograd", (0.95, 0.98)),
                       ("nvnovograd", (0.95, 0.98)), ("lamb", (0.9, 0.999)),
                       ("adamp", (0.9, 0.999))):
        tx, _ = tfactory.create_optimizer(opt, 1e-3, model, device="cpu")
        assert tx.betas == betas, opt
