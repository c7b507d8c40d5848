"""unite_torch grouped short-sequence attention (K5), the attention route and
the stage-1 step at mask 0.75 against unite_tpu, on the CPU.

The JAX side runs ``_grouped_attention`` (``_grouped_fwd_kernel`` and its
VJP, ``_grouped_bwd_kernel``) with ``_INTERPRET`` and ``_on_tpu`` patched,
emulated on the CPU; it pads the keys to a multiple of 128 and masks the
padded columns, which must not leak (100, 197, 393 and 392 leave a ragged
tile). The port's CPU path is the kernels' plain versions. Tolerances:
1e-5 in fp32 (summation order); in bf16 2e-2 absolute on values scaled to
at most 1, as for K1-K4 and K6 (the two packages round e at the same
points; a bf16 ulp of a value near 1 is 4e-3 and the sums differ in
order). The CUDA kernels are held against these plain versions on the card
by tests/test_torch_port_cuda.py.

The route: ``self_attention`` takes the kernel family JAX's dispatch takes
(``use_fused_qkv``, then ``multi_head_attention``'s 512-token split) for
every length from 1 to 2048, training and forward-only, at three widths. A
student at 392 visible tokens (stage 1 at mask 0.75) runs K5 in training
and K1 forward-only, and the fp32 stage-1 step at mask 0.75 matches the JAX
step over two steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA
from unite_tpu.engines.pretrain_umt import (
    make_pretrain_train_step as jax_step_builder,
)
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.optim import factory as jfactory
from unite_tpu.train.run_stage1 import unused_block_mask
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_torch.engines.pretrain_umt import make_pretrain_train_step
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.optim import factory as tfactory
from unite_torch.train.train_state import TrainState
from unite_torch.utils.flax_bridge import flax_to_state_dict

HEADS, SCALE = 2, 64 ** -0.5
DTYPES = [("float32", dict(rtol=1e-5, atol=1e-5)),
          ("bfloat16", dict(rtol=0, atol=2e-2))]
LENGTHS = [100, 197, 392, 393, 512]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(A, "_on_tpu", lambda: True)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _tdt(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _pair(shape, seed, dtype):
    """The same values for both packages, in the working type."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    j = jnp.asarray(_rand(shape, seed)).astype(jdt)
    return j, torch.from_numpy(_np(j)).to(_tdt(dtype))


def _scaled(a, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    return a / scale, ref / scale


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", LENGTHS)
def test_plain_k5_matches_pallas(interpret, s, dtype, tol):
    # forward and VJP of the Pallas grouped kernels against plain K5, with
    # B*H = 6 rows (not a multiple of the TPU's groups of 4, 8 or 16)
    shape = (3, HEADS, s, 64)
    (q, tq), (k, tk), (v, tv), (g, tg) = (_pair(shape, s + i, dtype)
                                          for i in range(4))
    out, vjp = jax.vjp(lambda *a: A._grouped_attention(*a, SCALE), q, k, v)
    refs = vjp(g)
    got, (m, l) = TA.grouped_fwd(tq, tk, tv, SCALE, with_stats=True)
    assert got.dtype == _tdt(dtype) and m.shape == l.shape == (3, HEADS, s)
    np.testing.assert_allclose(got.float().numpy(), _np(out), **tol)
    grads = TA.grouped_bwd(tq, tk, tv, tg, m, l, SCALE)
    for name, a, ref in zip("qkv", grads, refs):
        assert a.dtype == _tdt(dtype), name
        np.testing.assert_allclose(*_scaled(a.float().numpy(), _np(ref)),
                                   err_msg=f"d{name}", **tol)
    # the one-call plain backward is the same function
    for a, b in zip(grads, TA.grouped_reference_bwd(tq, tk, tv, tg,
                                                    scale=SCALE)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_k5_sums_the_unrounded_exponentials():
    # the rounding point that sets K5 apart from K1/K6: l sums the fp32 e
    q, k, v = (torch.from_numpy(_rand((1, 1, 50, 64), i)).to(torch.bfloat16)
               for i in range(3))
    _, m, l = TA.grouped_reference(q, k, v, scale=SCALE)
    s = q.float() @ k.float().transpose(-1, -2)
    e = torch.exp2((s - m[..., None]) * (SCALE * TA.INV_LN2))
    torch.testing.assert_close(l, e.sum(-1), rtol=0, atol=0)
    assert not torch.equal(l, e.to(torch.bfloat16).float().sum(-1))


def test_plain_k5_is_the_gradient_in_fp32():
    # fp32: the rounding points are no-ops, so plain K5's backward is
    # autograd's gradient of plain attention up to summation order
    q, k, v, g = (torch.from_numpy(_rand((2, 3, 70, 64), i)) for i in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = TA.attention_reference(*leaves, scale=SCALE)
    torch.testing.assert_close(TA.grouped_reference(q, k, v, scale=SCALE)[0],
                               ref.detach(), rtol=1e-5, atol=1e-5)
    ref.backward(g)
    for a, leaf in zip(TA.grouped_reference_bwd(q, k, v, g, scale=SCALE),
                       leaves):
        torch.testing.assert_close(a, leaf.grad, rtol=1e-5, atol=1e-5)


def _jax_route(s, fwd_only, dim):
    """The kernel family unite_tpu's models take on a TPU
    (models/layers.py:174-190 -> attention.py:1143-1151, 1231-1233)."""
    if A.use_fused_qkv(s, True, fwd_only=fwd_only, dim=dim):
        return "K1/K2" if s <= A.FUSED_QKV_FWD_MAX_SEQ else "K3/K4"
    return "K5" if s <= A.GROUPED_MAX_SEQ else "K6"


@pytest.mark.parametrize("fwd_only", [False, True])
@pytest.mark.parametrize("dim", [None, 768, 192])
def test_route_equals_jax_dispatch(monkeypatch, fwd_only, dim):
    taken = []
    monkeypatch.setattr(TA, "fused_qkv_attention", lambda qkv, *a: (
        taken.append("K1/K2" if qkv.shape[1] <= 512 else "K3/K4"),
        qkv[..., :64])[1])
    monkeypatch.setattr(TA._GroupedAttention, "apply",
                        lambda q, *a: (taken.append("K5"), q)[1])
    monkeypatch.setattr(TA._FlashAttention, "apply",
                        lambda q, *a: (taken.append("K6"), q)[1])
    qkv = torch.zeros((1, 2048, 3 * 64))
    want = []
    for s in range(1, 2049):
        TA.self_attention(qkv[:, :s], 1, SCALE, dim=dim, fwd_only=fwd_only)
        want.append(_jax_route(s, fwd_only, dim))
    assert taken == want
    assert TA.GROUPED_MAX_SEQ == A.GROUPED_MAX_SEQ
    # K5 takes training at 385-512 at any width and every length <= 512 at
    # widths that are not a multiple of 128
    n_k5 = want.count("K5")
    assert n_k5 == (512 if dim == 192 else 0 if fwd_only else 128)


# --------------------------------------------------------------- models

# 8 frames of 112^2 in patches of 8: 196 patches a frame as at 224^2 / 16,
# so mask 0.75 keeps 49 a frame, 392 tokens; widths 128 (a multiple of 128:
# the route turns on the length alone)
STUDENT = dict(img_size=112, patch_size=8, encoder_embed_dim=128,
               encoder_depth=2, encoder_num_heads=2, num_frames=8,
               tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
               clip_return_layers=(0, 1))
TEACHER = dict(input_resolution=112, patch_size=8, width=128, layers=2,
               heads=2, output_dim=64, return_attn=True, return_index=(0, 1))
GEOM = dict(num_patches=1568, frames=8, mask_ratio=0.75)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def batch_np(b=2, seed=0):
    rng = np.random.default_rng(seed)
    vids = rng.integers(0, 256, (b, 8, 112, 112, 3), dtype=np.uint8)
    idx = np.stack([np.sort(np.concatenate(
        [f * 196 + rng.choice(196, 49, replace=False) for f in range(8)]))
        for _ in range(b)]).astype(np.int32)
    return vids, idx


def _record_wrappers(monkeypatch):
    calls = []
    for name in ("fused_qkv_fwd", "fused_qkv_bwd", "grouped_fwd",
                 "grouped_bwd"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


def test_student_at_392_takes_k5_in_training_and_k1_forward_only(
        monkeypatch):
    sm = tad.AdaptationVisionTransformer(**STUDENT)
    vids, idx = batch_np()
    x = torch.from_numpy(vids).float() / 255.0
    counters = (TA.grouped_fwd, TA.grouped_dq, TA.grouped_dkv,
                TA.fused_qkv_fwd)
    before = [c.launches for c in counters]
    calls = _record_wrappers(monkeypatch)
    sm.train()(x, torch.from_numpy(idx).long(), clip_only=True).sum(
        ).backward()
    assert calls == ["grouped_fwd"] * 2 + ["grouped_bwd"] * 2
    calls.clear()
    with torch.no_grad():  # JAX's deterministic=False under no gradient
        sm(x, torch.from_numpy(idx).long(), clip_only=True)
    assert calls == ["grouped_fwd"] * 2
    calls.clear()
    with torch.no_grad():
        sm.eval()(x, torch.from_numpy(idx).long(), clip_only=True)
    assert calls == ["fused_qkv_fwd"] * 2
    # the CPU takes the plain versions: no kernel launch is counted
    assert [c.launches for c in counters] == before


def test_step_gate_at_mask_075_matches_jax_over_two_steps(monkeypatch):
    sj = jad.AdaptationVisionTransformer(**STUDENT)
    tj = jclip.CLIPVisionTransformer(**TEACHER)
    vids, idx = batch_np()
    x = jnp.asarray(vids[:1], jnp.float32)
    sp = perturb(sj.init(jax.random.PRNGKey(0), x, jnp.asarray(idx[:1]),
                         False)["params"], 1)
    tp = perturb(tj.init(jax.random.PRNGKey(1), x)["params"], 2)
    lr_tab = jsched.cosine_scheduler(5e-4, 2.5e-5, 1, 3, warmup_steps=1,
                                     start_warmup_value=2.5e-4)
    wd_tab = jsched.cosine_scheduler(0.05, 0.2, 1, 3)
    eps = 1e-6  # as in the other gates: see test_torch_port_step.py
    geom = dict(GEOM, source_batch_size=1, clip_loss_data="target",
                clip_grad=None, clip_input_resolution=112)
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr_tab, params=sp, weight_decay=wd_tab,
        betas=(0.9, 0.95), eps=eps, trainable_mask=unused_block_mask(sp, 1))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, sp), tx)
    # the JAX models take their TPU route: the student's grouped kernel in
    # interpret mode at 392 tokens, the teacher's fused-qkv kernel at 197
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(A, "_on_tpu", lambda: True)
    jstep = jax.jit(jax_step_builder(sj, tj, **geom))

    sm = tad.AdaptationVisionTransformer(**STUDENT)
    sm.load_state_dict(flax_to_state_dict(sp, patch_size=8))
    tm = tclip.CLIPVisionTransformer(**TEACHER)
    tm.load_state_dict(flax_to_state_dict(tp, kind="clip", patch_size=8))
    opt, _ = tfactory.create_optimizer("adamw", lr_tab, sm,
                                       weight_decay=wd_tab, betas=(0.9, 0.95),
                                       eps=eps, device="cpu")
    state = TrainState(sm, opt)
    step = make_pretrain_train_step(sm, tm, device="cpu", **geom)
    calls = _record_wrappers(monkeypatch)
    for i in range(2):
        vids, idx = batch_np(seed=10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, tp),
                           {"videos": jnp.asarray(vids),
                            "vis_idx": jnp.asarray(idx)},
                           jax.random.PRNGKey(0))
        m = step(state, {"videos": torch.from_numpy(vids),
                         "vis_idx": torch.from_numpy(idx)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5)
        ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params),
                                 patch_size=8)
        got = sm.state_dict()
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    # per step: the teacher's 2 layers on K1, the student's 2 on K5
    assert calls == (["fused_qkv_fwd"] * 2 + ["grouped_fwd"] * 2
                     + ["grouped_bwd"] * 2) * 2
