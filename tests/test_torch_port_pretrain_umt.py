"""unite_torch UMT pretrain student against unite_tpu, fp32 on the CPU.

At 8 frames of 224^2 with tubelet 1 and a tube mask of 0.8 the student runs
320 visible tokens, the card's K1/K2 route (their plain versions here), at
width 128 with 2 heads of 64. Masks are drawn per clip, so the sinusoid
table's gathered rows differ between clips; weights go through the bridge.
The gradient is that of sum((out - t)^2) against seeded targets t, since
sum(out^2) alone is constant under the L2 norm of the decoders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.models import pretrain_umt as jumt
from unite_torch.engines.pretrain_videomae import mask_indices
from unite_torch.models import pretrain_umt as tumt
from unite_torch.ops.attention import use_fused_qkv
from unite_torch.ops.masking import TubeMaskingGenerator
from unite_torch.utils.flax_bridge import flax_to_state_dict
from unite_torch.utils.registry import create_model

CFG = dict(img_size=224, patch_size=16, encoder_embed_dim=128,
           encoder_depth=3, encoder_num_heads=2, num_frames=8,
           tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
           clip_return_layer=2)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def inputs(b, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 8, 224, 224, 3)).astype(np.float32)
    gen = TubeMaskingGenerator((8, 14, 14), 0.8)
    vis, _ = mask_indices(np.stack([gen(rng) for _ in range(b)]))
    return x, vis


def _pair(**kw):
    cfg = dict(CFG, **kw)
    jm = jumt.PretrainUMT(**cfg)
    x, vis = inputs(1, 0)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(vis))["params"], 1)
    tm = tumt.PretrainUMT(**cfg)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    return jm, p, tm


@pytest.mark.parametrize("depth,n,interval", [(12, 6, 1), (12, 2, 2),
                                              (24, 3, 4), (3, 1, 1)])
def test_top_down_return_index(depth, n, interval):
    assert tumt.top_down_return_index(depth, n, interval) == \
        jumt.top_down_return_index(depth, n, interval)


def test_forward_and_grad_match_jax():
    jm, p, tm = _pair()
    x, vis = inputs(2, 2)
    assert vis.shape == (2, 320) and not np.array_equal(vis[0], vis[1])
    assert use_fused_qkv(320, False, 128)
    t = np.random.default_rng(3).standard_normal(
        (2, 2, 320, 64)).astype(np.float32)

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(vis))
        return jnp.sum((out - t) ** 2), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    tm.train()
    out = tm(torch.from_numpy(x), torch.from_numpy(vis))
    loss = torch.sum((out - torch.from_numpy(t)) ** 2)
    loss.backward()
    assert out.shape == (2, 2, 320, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jg))
    grads = {k: v.grad for k, v in tm.named_parameters()}
    assert set(ref) == set(grads)
    for k in ref:
        assert (grads[k] - ref[k]).norm() <= 1e-5 * ref[k].norm(), k


def test_gather_comes_before_the_projection():
    """The projection sees only the visible patch vectors (JAX's order):
    the patch embedding's input rows are the gathered ones."""
    _, _, tm = _pair()
    x, vis = inputs(2, 4)
    seen = []
    tm.encoder.patch_embed.proj.register_forward_hook(
        lambda m, i, o: seen.append(i[0].shape))
    with torch.no_grad():
        tm.eval()(torch.from_numpy(x), torch.from_numpy(vis))
    assert seen == [(2, 320, 16 * 16 * 3)]


@pytest.mark.parametrize("remat_num", [-1, 2])
def test_remat_is_bit_equal(remat_num):
    """Recomputed blocks (drop path 0.1, draws replayed from the step's
    generator) give the plain pass's outputs and gradients bit for bit."""
    _, p, _ = _pair()
    x, vis = inputs(2, 5)
    res = []
    for remat in (False, True):
        tm = tumt.PretrainUMT(**CFG, drop_path_rate=0.1, remat=remat,
                              remat_num=remat_num)
        tm.load_state_dict(flax_to_state_dict(p), strict=True)
        tm.train()
        gen = torch.Generator().manual_seed(11)
        out = tm(torch.from_numpy(x), torch.from_numpy(vis), gen)
        torch.sum(out ** 3).backward()
        res.append((out.detach(), {k: v.grad.clone()
                                   for k, v in tm.named_parameters()},
                    gen.get_state()))
    (o0, g0, s0), (o1, g1, s1) = res
    assert torch.equal(o0, o1) and torch.equal(s0, s1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("size,width,depth,heads", [("base", 768, 12, 12),
                                                    ("large", 1024, 24, 16)])
def test_factories_match_jax_geometry(size, width, depth, heads):
    name = f"pretrain_umt_{size}_patch16_224"
    m = create_model(name, device="meta", clip_return_layer=6)
    jm = jumt.__dict__[name](clip_return_layer=6)
    assert len(m.encoder.blocks) == depth == jm.encoder_depth
    assert m.encoder.blocks[0].attn.num_heads == heads
    assert m.encoder.norm.weight.shape == (width,)
    assert m.return_index == jumt.top_down_return_index(depth, 6, 1)
    assert len(m.clip_decoder) == 6
