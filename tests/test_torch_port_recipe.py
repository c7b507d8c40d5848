"""The finetune recipe's switches in unite_torch against unite_tpu, fp32 on
the CPU, at small widths.

* ``ops.mixup.Mixup``: its application, given the JAX ``Mixup``'s own draws
  (recorded from ``_sample_lam`` and ``_box``), gives JAX's mixed videos
  and soft targets to 1e-6 in every mode (batch, elem, pair with an even
  and an odd batch, ``cutmix_minmax``, ``correct_lam`` off, ``prob`` < 1,
  bf16 videos); its own draws are held by distribution (the Beta laws of
  lam, the gates' frequencies, the box's corrected lam against JAX's).
* ``data.collate_mixup.FastCollateMixup``: bit-equal to JAX's in every
  mode.
* Dropout: evaluation is the identity, rate 0 draws nothing, and with the
  JAX run's keep masks injected the port's ``Dropout``, attention dropout
  and a training ``Block`` give JAX's outputs; attention dropout in
  training takes the plain attention and evaluation the kernels' route.
* Remat (``--use_checkpoint``): the ViT and the adaptation student at drop
  path 0.1 and dropout 0.1 give bit-equal outputs and gradients with remat
  off, on and on the first block only; a checkpoint that redraws from the
  caller's generator does not (the gate sees the fault); against JAX's
  ``remat=True`` with the same draws injected, outputs and gradients agree
  to rtol 1e-5.
* ``--mu_dtype bfloat16``: ``ScheduledAdamW`` against
  ``optax.adamw(mu_dtype=jnp.bfloat16)`` over 3 steps (mu bit-equal,
  parameters to rtol 1e-6), and a checkpoint round trip bit for bit.
* The entries: ``run_stage2.main`` with mixup and cutmix (both packages'
  draw functions patched to the same fixed draws) and ``--use_checkpoint``
  against the JAX entry (the stage-2 entry test's gate), and with
  ``--mu_dtype bfloat16`` beside them (a bf16 moment's rounding can flip
  on fp32 noise: the bound is stated there); ``run_stage1.main`` and
  ``run_stage3.main`` with ``--use_checkpoint --mu_dtype bfloat16`` against
  theirs (the entry tests' own harnesses and gates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tests.test_torch_port_entry as s1t
import tests.test_torch_port_stage2_entry as s2t
import tests.test_torch_port_stage3_entry as s3t
from unite_tpu.data import collate_mixup as jcm
from unite_tpu.models import adaptation as jad
from unite_tpu.models import layers as jl
from unite_tpu.models import vit as jvit
from unite_tpu.ops import attention as jattn
from unite_tpu.ops import mixup as jmix
from unite_torch.data import collate_mixup as tcm
from unite_torch.models import adaptation as tad
from unite_torch.models import layers as tl
from unite_torch.models import vit as tvit
from unite_torch.ops import attention as tattn
from unite_torch.ops import mixup as tmix
from unite_torch.optim import factory as tfactory
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck
from unite_torch.utils.flax_bridge import flax_to_state_dict


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(a).detach().float()),
        np.asarray(jnp.asarray(b, jnp.float32)), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- Mixup

MIXUP_CASES = {
    "batch": (dict(mixup_alpha=0.8, cutmix_alpha=1.0), 4, jnp.float32),
    "batch_bf16": (dict(mixup_alpha=0.8, cutmix_alpha=1.0), 4, jnp.bfloat16),
    "elem_prob": (dict(mixup_alpha=0.8, cutmix_alpha=1.0, mode="elem",
                       prob=0.6, switch_prob=0.4), 6, jnp.float32),
    "pair_even": (dict(mixup_alpha=0.8, cutmix_alpha=1.0, mode="pair"), 6,
                  jnp.float32),
    "pair_odd": (dict(mixup_alpha=0.8, cutmix_alpha=1.0, mode="pair"), 5,
                 jnp.float32),
    "mixup_only": (dict(mixup_alpha=1.0, mode="elem"), 4, jnp.float32),
    "cutmix_uncorrected": (dict(mixup_alpha=0.0, cutmix_alpha=1.0,
                                correct_lam=False), 4, jnp.float32),
    "minmax_elem": (dict(mixup_alpha=0.0, cutmix_minmax=(0.2, 0.8),
                         mode="elem", prob=0.7), 6, jnp.float32),
}


def _recording(jm):
    """Record the JAX instance's draws, as its __call__ makes them."""
    rec = {}
    sample, box = jm._sample_lam, jm._box

    def sample_rec(rng, shape=()):
        rec["lam"] = sample(rng, shape)
        return rec["lam"]

    def box_rec(rng, h, w, lam, count=()):
        rec["box"] = box(rng, h, w, lam, count)
        return rec["box"]

    jm._sample_lam, jm._box = sample_rec, box_rec
    return rec


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.mark.parametrize("case", list(MIXUP_CASES))
def test_mixup_application_on_jax_draws_matches_jax(case):
    kw, b, dtype = MIXUP_CASES[case]
    kw = dict(kw, label_smoothing=0.1, num_classes=7)
    jm, tm = jmix.Mixup(**kw), tmix.Mixup(**kw)
    rng = np.random.default_rng(3)
    seen_cut = seen_mix = False
    for seed in range(8):
        x = rng.standard_normal((b, 2, 12, 10, 3)).astype(np.float32)
        labels = rng.integers(0, 7, b).astype(np.int32)
        rec = _recording(jm)
        ref_x, ref_t = jm(jax.random.PRNGKey(seed),
                          jnp.asarray(x, dtype), jnp.asarray(labels))
        lam, cut, mix = map(_t, rec["lam"])
        box, lam_cut = map(_t, rec["box"])
        seen_cut |= bool((cut & mix).any())
        seen_mix |= bool((~cut & mix).any())
        tx = _t(jnp.asarray(x, dtype).astype(jnp.float32)).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        got_x, got_t = tm.apply(tx, torch.from_numpy(labels), lam, cut, mix,
                                box, lam_cut)
        assert got_x.dtype == tx.dtype and got_x.shape == tx.shape
        close(got_x, ref_x)
        close(got_t, ref_t)
    # the seeds reach the mixup and the cutmix branches the configuration
    # has
    assert seen_cut == (kw.get("cutmix_alpha", 0) > 0
                        or "cutmix_minmax" in kw)
    assert seen_mix == (kw.get("mixup_alpha", 1.0) > 0)


def test_mixup_refuses_no_alpha():
    for m in (jmix.Mixup, tmix.Mixup):
        with pytest.raises(ValueError, match="mixup_alpha"):
            m(mixup_alpha=0.0, cutmix_alpha=0.0)


def test_mixup_draws_by_distribution():
    from scipy import stats

    g = torch.Generator().manual_seed(0)
    n = 20000
    tm = tmix.Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, mode="elem",
                    prob=0.7, switch_prob=0.4)
    lam, cut, mix = tm._sample_lam(g, (n,))
    assert abs(mix.float().mean().item() - 0.7) < 0.02
    assert abs(cut.float().mean().item() - 0.4) < 0.02
    assert torch.all(lam[~mix] == 1.0)
    for sel, a in ((mix & ~cut, 0.8), (mix & cut, 1.0)):
        p = stats.kstest(lam[sel].numpy(), stats.beta(a, a).cdf).pvalue
        assert p > 1e-3, (a, p)
    # the box's corrected lam against JAX's boxes at the same lam
    lam_in = np.full(4000, 0.6, np.float32)
    _, ref = jmix.Mixup(mixup_alpha=0.0, cutmix_alpha=1.0)._box(
        jax.random.PRNGKey(1), 14, 18, jnp.asarray(lam_in), (4000,))
    box, got = tm._box(g, 14, 18, torch.from_numpy(lam_in), (4000,))
    assert box.shape == (4000, 14, 18)
    assert np.allclose(got.numpy(), 1.0 - box.float().mean((1, 2)).numpy())
    assert stats.ks_2samp(got.numpy(), np.asarray(ref)).pvalue > 1e-3
    # cutmix_minmax: sides uniform fractions in [0.2, 0.8), inside the image
    mm = tmix.Mixup(mixup_alpha=0.0, cutmix_minmax=(0.2, 0.8), mode="elem")
    _, jlam = jmix.Mixup(mixup_alpha=0.0, cutmix_minmax=(0.2, 0.8))._box(
        jax.random.PRNGKey(2), 20, 30, None, (4000,))
    box, lam_mm = mm._box(g, 20, 30, None, (4000,))
    rows, cols = box.any(2).sum(1), box.any(1).sum(1)
    assert rows.min() >= 4 and rows.max() < 16 and cols.min() >= 6 \
        and cols.max() < 24
    assert stats.ks_2samp(lam_mm.numpy(), np.asarray(jlam)).pvalue > 1e-3
    # a batch draw on the same generator state repeats
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    x = torch.randn(4, 2, 8, 8, 3)
    y = torch.arange(4) % 3
    a, b = tm(x, y, g1), tm(x, y, g2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("mode", ["batch", "elem", "pair", "half"])
@pytest.mark.parametrize("kw", [dict(mixup_alpha=0.8, cutmix_alpha=1.0),
                                dict(mixup_alpha=0.0,
                                     cutmix_minmax=(0.3, 0.7), prob=0.8)])
def test_fast_collate_mixup_is_bit_equal_to_jax(mode, kw):
    rng = np.random.default_rng(11)
    kw = dict(kw, mode=mode, label_smoothing=0.1, num_classes=5, seed=4)
    port, ref = tcm.FastCollateMixup(**kw), jcm.FastCollateMixup(**kw)
    for _ in range(6):
        items = [(rng.integers(0, 256, (2, 10, 12, 3), dtype=np.uint8),
                  int(rng.integers(0, 5)), "vid") for _ in range(6)]
        got, want = port(items), ref(items)
        assert got[0].dtype == np.uint8
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    from unite_torch.data import FastCollateMixup

    assert FastCollateMixup is tcm.FastCollateMixup


# ----------------------------------------------- draws injected on both sides


class Draws:
    """Keep masks injected into both packages: ``record_jax`` has every
    ``jax.random.bernoulli`` of a JAX run (traced or not) return a seeded
    numpy mask of the asked shape and keep it, in call order; the masks
    replay into a JAX run in the same order, and into the port keyed by the
    generator's draw, so that a recompute that replays the generator gets
    the same mask again."""

    def __init__(self, monkeypatch, seed=0):
        self.mp, self.masks, self.memo = monkeypatch, [], {}
        self.rng = np.random.default_rng(seed)

    def record_jax(self):
        def rec(key, p=0.5, shape=None):
            m = self.rng.random(tuple(shape)) < p
            self.masks.append(m)
            return jnp.asarray(m)

        self.mp.setattr(jax.random, "bernoulli", rec)

    def replay_jax(self):
        it = iter(list(self.masks))

        def replay(key, p=0.5, shape=None):
            m = next(it)
            assert tuple(shape) == m.shape
            return jnp.asarray(m)

        self.mp.setattr(jax.random, "bernoulli", replay)

    def into_port(self):
        masks = list(self.masks)

        def injected(shape, keep, generator, device):
            key = int(torch.randint(0, 2 ** 62, (), generator=generator))
            if key not in self.memo:
                m = masks[len(self.memo)]
                assert tuple(shape) == m.shape, (tuple(shape), m.shape)
                self.memo[key] = torch.from_numpy(m.copy())
            return self.memo[key]

        for mod in (tattn, tl):
            self.mp.setattr(mod, "keep_mask", injected)


def test_dropout_eval_is_identity_and_rate_zero_draws_nothing():
    x = torch.randn(3, 5, 8)
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    d = tl.Dropout(0.4).eval()
    assert d(x, g) is x
    d0 = tl.Dropout(0.0).train()
    assert d0(x, g) is x
    assert torch.equal(g.get_state(), state)
    out = tl.Dropout(0.4).train()(x, g)
    kept = out != 0
    assert torch.allclose(out[kept], x[kept] / 0.6)
    assert 0.4 < kept.float().mean().item() < 0.8


def test_dropout_with_injected_masks_matches_jax(monkeypatch):
    import flax.linen as nn

    draws = Draws(monkeypatch)
    draws.record_jax()
    x = np.random.default_rng(0).standard_normal((4, 6, 16)).astype(
        np.float32)
    ref = nn.Dropout(0.3).apply({}, jnp.asarray(x), deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(2)})
    draws.into_port()
    got = tl.Dropout(0.3).train()(torch.from_numpy(x),
                                  torch.Generator().manual_seed(0))
    close(got, ref)


def test_attention_dropout_with_injected_masks_matches_jax(monkeypatch):
    draws = Draws(monkeypatch)
    draws.record_jax()
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
               for _ in range(3))
    ref = jattn.attention_xla(*map(jnp.asarray, (q, k, v)), scale=0.25,
                              dropout_rate=0.2,
                              dropout_rng=jax.random.PRNGKey(3),
                              deterministic=False)
    draws.into_port()
    got = tattn.attention_reference(
        *map(torch.from_numpy, (q, k, v)), scale=0.25, dropout_rate=0.2,
        generator=torch.Generator().manual_seed(0))
    close(got, ref)


@pytest.mark.parametrize("attn_drop", [0.0, 0.2])
def test_training_block_with_injected_draws_matches_jax(monkeypatch,
                                                        attn_drop):
    draws = Draws(monkeypatch)
    kw = dict(drop=0.1, attn_drop=attn_drop, drop_path=0.1)
    jm = jl.Block(num_heads=2, qkv_bias=True, **kw)
    x = np.random.default_rng(0).standard_normal((3, 37, 128)).astype(
        np.float32)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    draws.record_jax()
    ref = jm.apply({"params": p}, jnp.asarray(x), False,
                   rngs={"dropout": jax.random.PRNGKey(5)})
    # attention probabilities, proj, drop path, MLP, drop path
    assert len(draws.masks) == 4 + (attn_drop > 0)
    draws.into_port()
    tm = tl.Block(128, 2, qkv_bias=True, drop_path=0.1, drop=0.1,
                  attn_drop=attn_drop)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    got = tm.train()(torch.from_numpy(x), torch.Generator().manual_seed(0))
    close(got, ref, rtol=1e-5, atol=1e-5)


def test_attention_dropout_routes_like_jax(monkeypatch):
    # JAX sends attention dropout in training to XLA, past its kernels;
    # the port sends it to the plain attention and keeps K1/K3 otherwise
    seen = []
    fused, plain = tattn.fused_qkv_attention, tattn.attention_reference
    monkeypatch.setattr(tattn, "fused_qkv_attention",
                        lambda *a, **k: seen.append("kernel") or fused(*a,
                                                                       **k))
    monkeypatch.setattr(tattn, "attention_reference",
                        lambda *a, **k: seen.append("plain") or plain(*a,
                                                                      **k))
    x = torch.randn(2, 20, 128)
    g = torch.Generator().manual_seed(0)
    for drop, train, want in ((0.1, True, "plain"), (0.1, False, "kernel"),
                              (0.0, True, "kernel")):
        seen.clear()
        tm = tl.Attention(128, 2, qkv_bias=True, attn_drop=drop)
        tm.train(train)(x, g)
        assert seen == [want], (drop, train, seen)


# ------------------------------------------------------------------- remat

VIT = dict(img_size=32, patch_size=16, num_classes=5, embed_dim=128,
           depth=3, num_heads=2, all_frames=2, tubelet_size=1,
           init_scale=0.5, drop_path_rate=0.1, drop_rate=0.1,
           attn_drop_rate=0.1, fc_drop_rate=0.1)
STUDENT = dict(img_size=32, patch_size=16, encoder_embed_dim=128,
               encoder_depth=3, encoder_num_heads=2, num_frames=2,
               tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
               clip_return_layers=(1, 2), drop_path_rate=0.1, drop_rate=0.1,
               attn_drop_rate=0.1)


def _inputs(kind):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2, 32, 32, 3)).astype(np.float32)
    if kind == "vit":
        return x, None, rng.standard_normal((3, 5)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(8, 5, replace=False))
                    for _ in range(3)]).astype(np.int32)
    return x, idx, rng.standard_normal((2, 3, 5, 64)).astype(np.float32)


def _port_model(kind, state, **kw):
    cls = tvit.VisionTransformer if kind == "vit" else \
        tad.AdaptationVisionTransformer
    m = cls(**dict(VIT if kind == "vit" else STUDENT, **kw))
    m.load_state_dict(state, strict=True)
    return m.train()


def _port_grads(m, kind, seed=3):
    x, idx, w = _inputs(kind)
    g = torch.Generator().manual_seed(seed)
    if kind == "vit":
        out = m(torch.from_numpy(x), g)
    else:
        out = m(torch.from_numpy(x), torch.from_numpy(idx).long(),
                clip_only=True, generator=g)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in m.named_parameters()
                          if p.grad is not None}


def _jax_params(kind, remat=False):
    x, idx, _ = _inputs(kind)
    if kind == "vit":
        jm = jvit.VisionTransformer(**VIT, remat=remat)
        p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    else:
        jm = jad.AdaptationVisionTransformer(**STUDENT, remat=remat)
        p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(idx),
                    True)["params"]
    return jm, perturb(p, 1)


def _port_state(kind):
    torch.manual_seed(2)
    cls = tvit.VisionTransformer if kind == "vit" else \
        tad.AdaptationVisionTransformer
    m = cls(**(dict(VIT, init_scale=1.0) if kind == "vit" else STUDENT))
    return {k: v + 0.02 * torch.randn_like(v)
            for k, v in m.state_dict().items()}


@pytest.mark.parametrize("kind", ["vit", "student"])
def test_remat_is_bit_equal_to_the_plain_step(kind):
    state = _port_state(kind)
    out0, g0 = _port_grads(_port_model(kind, state), kind)
    assert g0
    for kw in (dict(remat=True), dict(remat=True, remat_num=1)):
        out, g = _port_grads(_port_model(kind, state, **kw), kind)
        assert torch.equal(out, out0), kw
        assert g.keys() == g0.keys()
        for n in g0:
            assert torch.equal(g[n], g0[n]), (kw, n)


def test_a_recompute_that_redraws_gives_other_gradients(monkeypatch):
    # the fault the remat gate exists for: torch's checkpoint with the
    # caller's generator (as it stands after the forward) in the recompute
    state = _port_state("vit")
    _, g0 = _port_grads(_port_model("vit", state), "vit")
    from torch.utils.checkpoint import checkpoint

    monkeypatch.setattr(tvit, "remat_block", lambda blk, x, gen: checkpoint(
        blk, x, gen, use_reentrant=False))
    _, g = _port_grads(_port_model("vit", state, remat=True), "vit")
    assert any(not torch.equal(g[n], g0[n]) for n in g0)


@pytest.mark.parametrize("kind", ["vit", "student"])
def test_remat_matches_jax_remat_with_injected_draws(monkeypatch, kind):
    draws = Draws(monkeypatch)
    x, idx, w = _inputs(kind)
    jm, p = _jax_params(kind, remat=True)
    jplain, _ = _jax_params(kind)

    def loss(params, model):
        args = (jnp.asarray(x),) if kind == "vit" else (
            jnp.asarray(x), jnp.asarray(idx), True)
        out = model.apply({"params": params}, *args, False,
                          rngs={"dropout": jax.random.PRNGKey(7)})
        return (out * jnp.asarray(w)).sum(), out

    draws.record_jax()
    (_, ref_plain), _ = jax.jit(jax.value_and_grad(
        lambda q: loss(q, jplain), has_aux=True))(p)
    draws.replay_jax()
    (_, ref), grads = jax.jit(jax.value_and_grad(
        lambda q: loss(q, jm), has_aux=True))(p)
    # the replay reaches JAX's remat: its output is the plain one's
    close(ref, ref_plain, rtol=1e-6, atol=1e-6)
    draws.into_port()
    out, g = _port_grads(_port_model(kind, flax_to_state_dict(p),
                                     remat=True), kind)
    # every mask the JAX run drew was taken, each once (the recompute
    # replayed its own)
    assert len(draws.memo) == len(draws.masks) > 6
    close(out, ref, rtol=1e-5, atol=1e-6)
    # rtol 1e-5, and 1e-5 of each tensor's scale for its entries near 0
    ref_g = flax_to_state_dict(grads)
    for n, v in g.items():
        close(v, ref_g[n].numpy(), rtol=1e-5,
              atol=1e-5 * float(np.abs(ref_g[n].numpy()).max()))


# ------------------------------------------------------------ bf16 first moment


def _adam_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": rng.standard_normal((48,)).astype(np.float32),
            "v": rng.standard_normal((3, 7, 11)).astype(np.float32)}


def test_bf16_first_moment_matches_optax():
    params = _adam_params()
    lr, wd = 1e-2, 0.05
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd,
                     mu_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tfactory.ScheduledAdamW([{"params": list(tp.values()),
                                    "lr_scale": 1.0, "decay": True}],
                                  lr, wd, betas=(0.9, 0.999), eps=1e-8,
                                  mu_dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    mu_ref = jstate[0].mu
    for k, p in tp.items():
        mu = opt.state[p]["mu"]
        assert mu.dtype == torch.bfloat16 and opt.state[p]["nu"].dtype == \
            torch.float32
        ref = np.asarray(mu_ref[k]).view(np.uint16)
        np.testing.assert_array_equal(mu.view(torch.int16).numpy().view(
            np.uint16), ref, err_msg=k)
        # parameters of scale 1: a few fp32 ulps of that scale apart where
        # an update left a value near 0
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_bf16_first_moment_checkpoint_round_trip(tmp_path):
    def state(seed):
        torch.manual_seed(seed)
        m = torch.nn.Linear(12, 5)
        opt, _ = tfactory.create_optimizer(
            "adamw", 1e-2, m, weight_decay=0.05, mu_dtype=torch.bfloat16,
            device="cpu")
        return TrainState(m, opt)

    def step(s, seed):
        g = torch.Generator().manual_seed(seed)
        s.optimizer.zero_grad()
        s.model(torch.randn(4, 12, generator=g)).square().sum().backward()
        s.apply_gradients()

    a = state(0)
    for i in range(2):
        step(a, i)
    ck.save_train_state(str(tmp_path), 0, a)
    saved = ck.load_checkpoint(str(tmp_path / "checkpoint-latest.pth"))
    b = ck.restore_train_state(state(1), saved)
    names = dict(b.model.named_parameters())
    for n, p in a.model.named_parameters():
        sa, sb = a.optimizer.state[p], b.optimizer.state[names[n]]
        assert sb["mu"].dtype == torch.bfloat16
        for k in ("mu", "nu"):
            assert torch.equal(sa[k], sb[k]), (n, k)
            assert torch.equal(saved["optimizer"]["moments"][n][k], sa[k])
    step(a, 5)
    step(b, 5)
    for n, p in a.model.named_parameters():
        assert torch.equal(p, names[n]), n


# ------------------------------------------------------------------ entries


def _fixed_draws(monkeypatch, batch):
    """Both packages' Mixup draw functions patched to one fixed set of elem
    draws: mixup rows, cutmix rows and one row the prob gate excludes."""
    lam = np.linspace(0.2, 0.9, batch).astype(np.float32)
    cut = np.arange(batch) % 2 == 0
    mix = np.arange(batch) % 4 != 3
    cy, cx = np.arange(batch) % 4 * 7, np.arange(batch) % 3 * 9

    def box(h, w):
        m, lc = tmix.Mixup.box_from(h, w, torch.from_numpy(lam),
                                    torch.from_numpy(cy),
                                    torch.from_numpy(cx))
        return m.numpy(), lc.numpy()

    monkeypatch.setattr(jmix.Mixup, "_sample_lam", lambda self, rng, shape=(
        ): (jnp.asarray(lam), jnp.asarray(cut), jnp.asarray(mix)))
    monkeypatch.setattr(jmix.Mixup, "_box", lambda self, rng, h, w, lam_,
                        count=(): tuple(map(jnp.asarray, box(h, w))))
    monkeypatch.setattr(tmix.Mixup, "_sample_lam", lambda self, g, shape=(),
                        device=None: (torch.from_numpy(lam),
                                      torch.from_numpy(cut),
                                      torch.from_numpy(mix)))
    monkeypatch.setattr(tmix.Mixup, "_box", lambda self, g, h, w, lam_,
                        count=(), device=None: tuple(
                            map(torch.from_numpy, box(h, w))))


RECIPE = dict(mixup=0.8, cutmix=1.0, mixup_prob=1.0, mixup_mode="elem",
              smoothing=0.1, use_checkpoint=True,
              # Adam's eps above the 1e-6 of the other entry tests: the
              # jitted JAX mix fuses x*lam + x_flip*(1-lam) on the CPU and
              # differs from its own op-by-op result (which the port's
              # equals, test_mixup_application_on_jax_draws_matches_jax) by
              # one bf16 ulp in ~0.1% of the mixed pixels, and eps 1e-6
              # turns that, in the patch embedding's near-zero gradients,
              # into parameter moves above the gate (ROADMAP queue 3, item
              # 5's tolerance note)
              opt_eps=1e-4)


def test_stage2_entry_with_the_recipe_matches_the_jax_entry(tmp_path,
                                                            monkeypatch):
    _fixed_draws(monkeypatch, 8)
    monkeypatch.setitem(s2t.ENTRY_CASES, "recipe", RECIPE)
    s2t.test_entry_matches_the_jax_entry(tmp_path, "recipe")


def test_stage2_entry_with_bf16_moments_matches_the_jax_entry(tmp_path,
                                                              monkeypatch):
    """The recipe with --mu_dtype bfloat16. A one-ulp fp32 difference in a
    gradient (the two packages sum in different orders) can flip the bf16
    rounding of that element's first moment, a change of 2^-8 of it; the
    parameter then moves by at most lr * 2^-8 / (1 - b1) more or less over
    the run (the moment's decay). So the metrics keep rtol 1e-5, ECE (a
    difference of means of probabilities) an absolute 1e-5, and the
    parameters that bound; the moment itself is held bit for bit to
    optax's on the same gradients (test_bf16_first_moment_matches_optax)."""
    from unite_tpu.train import run_stage2 as jrun2
    from unite_tpu.utils.checkpoint import load_checkpoint as jload
    from unite_torch.train import run_stage2

    _fixed_draws(monkeypatch, 8)
    jargs = s2t._jax_args(tmp_path, tmp_path / "jax", finetune=s2t._weights(
        tmp_path, "published"), mu_dtype="bfloat16", **RECIPE)
    run_stage2.main(s2t._port_args(jargs, tmp_path / "port"), device="cpu")
    jrun2.main(jargs)
    got, ref = s2t._records(tmp_path / "port"), s2t._records(tmp_path / "jax")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref] == [0, 1, 2]
    for g, r in zip(got, ref):
        for k in ("train_loss", "train_grad_norm", "val_acc1", "val_acc5",
                  "val_ece", "val_loss", "test_acc1", "test_acc5"):
            assert (k in g) == (k in r), k
            if k in r:
                np.testing.assert_allclose(
                    g[k], r[k], rtol=1e-5, atol=1e-5 if k == "val_ece" else 0,
                    err_msg=f"{k} {r['epoch']}")
    mine = ck.load_checkpoint(str(tmp_path / "port" /
                                  "checkpoint-latest.pth"))
    theirs = flax_to_state_dict(jload(str(tmp_path / "jax" /
                                          "checkpoint-latest.msgpack")
                                      )["model"], patch_size=8)
    assert {m["mu"].dtype for m in mine["optimizer"]["moments"].values()
            } == {torch.bfloat16}
    bound = jargs.lr * 2.0 ** -8 / (1.0 - 0.9)
    assert set(mine["model"]) <= set(theirs)
    for k, v in mine["model"].items():
        np.testing.assert_allclose(v.numpy(), theirs[k].numpy(), rtol=0,
                                   atol=bound, err_msg=k)


def test_stage1_entry_with_remat_and_bf16_moments_matches_the_jax_entry(
        tmp_path, monkeypatch):
    entry_args = s1t._entry_args
    monkeypatch.setattr(s1t, "_entry_args", lambda *a, **k: entry_args(
        *a, **dict(k, use_checkpoint=True, mu_dtype="bfloat16")))
    s1t.test_entry_matches_the_jax_entry(tmp_path, monkeypatch)


def test_stage3_entry_with_remat_and_bf16_moments_matches_the_jax_entry(
        tmp_path, monkeypatch):
    monkeypatch.setitem(s3t.ENTRY_CASES, "remat_bf16_mu", lambda t: dict(
        use_checkpoint=True, mu_dtype="bfloat16"))
    s3t.test_entry_matches_the_jax_entry(tmp_path, "remat_bf16_mu")
