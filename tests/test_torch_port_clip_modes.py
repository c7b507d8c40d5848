"""unite_torch CLIP's masked-teacher (``vis_idx``) and ``return_cls`` modes
against unite_tpu, fp32 on the CPU.

Width 128 with 2 heads of 64 over 4 frames of 224^2: a tube mask of 0.8
keeps 40 of 196 patches a frame, so each frame runs 41 tokens (K1's
forward-only route, its plain version here). Masks are drawn per clip, so
a CLS row refolded in front of the wrong frame's patches would show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.models import clip as jclip
from unite_torch.engines.pretrain_videomae import mask_indices
from unite_torch.models import clip as tclip
from unite_torch.ops.attention import use_fused_qkv
from unite_torch.ops.masking import TubeMaskingGenerator
from unite_torch.utils.flax_bridge import flax_to_state_dict

CFG = dict(input_resolution=224, patch_size=16, width=128, layers=3, heads=2,
           output_dim=64, return_index=(1, 2))
TOL = dict(rtol=1e-5, atol=1e-5)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, 224, 224, 3)).astype(np.float32)
    gen = TubeMaskingGenerator((4, 14, 14), 0.8)
    vis, _ = mask_indices(np.stack([gen(rng) for _ in range(b)]))
    return x, vis


def _pair(**kw):
    cfg = dict(CFG, **kw)
    jm = jclip.CLIPVisionTransformer(**cfg)
    x, _ = inputs(1, 9)
    p = perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 2)
    tm = tclip.CLIPVisionTransformer(**cfg)
    tm.load_state_dict(flax_to_state_dict(p, kind="clip"), strict=True)
    return jm, p, tm.eval()


def close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("raw_taps", [False, True])
def test_masked_teacher_with_cls(raw_taps):
    jm, p, tm = _pair(return_attn=True, return_cls=True)
    x, vis = inputs()
    assert vis.shape == (2, 160) and not np.array_equal(vis[0], vis[1])
    assert use_fused_qkv(41, True)
    with torch.no_grad():
        z, attn, cls = tm(torch.from_numpy(x), raw_taps=raw_taps,
                          vis_idx=torch.from_numpy(vis))
    jz, jattn, jcls = jm.apply({"params": p}, jnp.asarray(x),
                               jnp.asarray(vis), raw_taps=raw_taps)
    assert attn is None and jattn is None  # no attention row under a mask
    assert z.shape == (2, 2, 160, 128 if raw_taps else 64)
    assert cls.shape == (8, 128)
    close(z, jz)
    close(cls, jcls)


def test_cls_without_mask_keeps_the_attention_row():
    jm, p, tm = _pair(return_attn=True, return_cls=True)
    x, _ = inputs()
    with torch.no_grad():
        z, attn, cls = tm(torch.from_numpy(x))
    jz, jattn, jcls = jm.apply({"params": p}, jnp.asarray(x))
    assert attn.shape == (8, 196)
    close(z, jz)
    close(attn, jattn)
    close(cls, jcls)


def test_masked_teacher_alone_and_cls_features():
    jm, p, tm = _pair()
    x, vis = inputs(seed=3)
    with_cls = tclip.CLIPVisionTransformer(**CFG, return_cls=True).eval()
    with_cls.load_state_dict(tm.state_dict())
    with torch.no_grad():
        z = tm(torch.from_numpy(x), vis_idx=torch.from_numpy(vis))
        z_cls, _ = with_cls(torch.from_numpy(x),
                            vis_idx=torch.from_numpy(vis))
        feats = tm(torch.from_numpy(x), cls_features=True,
                   vis_idx=torch.from_numpy(vis))
    close(z, jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(vis)))
    assert torch.equal(z, z_cls)  # return_cls only adds an output
    close(feats, jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(vis),
                          cls_features=True))
    assert feats.shape == (8, 64)
