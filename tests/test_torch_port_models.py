"""unite_torch models against the unite_tpu flax modules, fp32 on the CPU.

Weights come from the flax module's ``init`` (plus seeded noise, so biases
and layer-scales are not trivially zero or one) and reach the port through
``unite_torch.utils.flax_bridge``. Width 128, 2 heads of 64, a few layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.models import layers as jl
from unite_tpu.utils.torch_export import flax_params_to_state
from unite_tpu.utils.torch_import import clip_key_to_flax, torch_key_to_flax
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.models import layers as tl
from unite_torch.utils.flax_bridge import flatten, flax_to_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)  # outputs are O(1): 1e-5 of their scale


def perturb(params, seed):
    """Every leaf plus N(0, 0.02) noise (numpy), as a nested dict."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def videos(b, t, hw, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, t, hw, hw, 3)).astype(np.float32)


def vis_idx(b, n_frames, per_frame, keep, seed):
    rng = np.random.default_rng(seed)
    return np.stack([np.sort(np.concatenate(
        [f * per_frame + rng.choice(per_frame, keep, replace=False)
         for f in range(n_frames)])) for _ in range(b)]).astype(np.int32)


def load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.detach().float() if
                                          torch.is_tensor(a) else a),
                               np.asarray(b, np.float32), **(tol or TOL))


@pytest.mark.parametrize("init_values", [None, 0.1])
def test_block(init_values):
    jm = jl.Block(num_heads=2, qkv_bias=True, init_values=init_values)
    x = np.random.default_rng(0).standard_normal((2, 37, 128)).astype(np.float32)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    tm = load(tl.Block(128, 2, qkv_bias=True, init_values=init_values),
              flax_to_state_dict(p))
    close(tm(torch.from_numpy(x)), jm.apply({"params": p}, jnp.asarray(x)))


def test_patch_embed_gathers_before_projection():
    jm = jl.PatchEmbed(embed_dim=128, patch_size=16, tubelet_size=2)
    x = videos(2, 4, 32, 2)
    idx = vis_idx(2, 2, 4, 3, 3)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    state = {k[len("patch_embed."):]: v for k, v in
             flax_to_state_dict({"patch_embed": p}).items()}
    assert state["proj.weight"].shape == (128, 3, 2, 16, 16)  # Conv3d shape
    tm = load(tl.PatchEmbed(128, 16, 2), state)
    ref = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(idx))
    close(tm(torch.from_numpy(x), torch.from_numpy(idx).long()), ref)
    # the Conv3d-shaped weight is the reference's convolution
    conv = torch.nn.functional.conv3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), state["proj.weight"],
        state["proj.bias"], stride=(2, 16, 16))
    full = conv.flatten(2).transpose(1, 2)
    close(tm(torch.from_numpy(x)), full.numpy(), rtol=1e-5, atol=1e-5)


def test_gelu_and_layer_norm_policy():
    x = torch.linspace(-4, 4, 101)
    assert torch.equal(tl.gelu_for(torch.float32)(x),
                       torch.nn.functional.gelu(x))
    close(tl.gelu_for(torch.bfloat16)(x),
          np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True)))
    xb = torch.randn(4, 16).to(torch.bfloat16)
    y = tl.layer_norm(xb, torch.ones(16), torch.zeros(16), 1e-6)
    assert y.dtype == torch.bfloat16
    ref = jl.layer_norm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                        jnp.ones(16), jnp.zeros(16), 1e-6)
    close(y, np.asarray(ref.astype(jnp.float32)), rtol=0, atol=1e-2)


def _clip_pair(**kw):
    cfg = dict(input_resolution=32, patch_size=16, width=128, layers=3,
               heads=2, output_dim=64, return_attn=True, return_index=(1, 2))
    cfg.update(kw)
    jm = jclip.CLIPVisionTransformer(**cfg)
    x = videos(2, 2, 32, 4)
    p = perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 5)
    tm = load(tclip.CLIPVisionTransformer(**cfg),
              flax_to_state_dict(p, kind="clip"))
    return jm, p, tm, x


def test_clip_teacher_taps_and_attention_row():
    jm, p, tm, x = _clip_pair()
    with torch.no_grad():
        z, attn = tm(torch.from_numpy(x), raw_taps=True)
        zp, attn2 = tm(torch.from_numpy(x))
    jz, jattn = jm.apply({"params": p}, jnp.asarray(x), raw_taps=True)
    jzp, _ = jm.apply({"params": p}, jnp.asarray(x))
    assert z.shape == (2, 2, 8, 128) and attn.shape == (4, 4)
    close(z, jz)
    close(attn, jattn)
    close(zp, jzp)
    torch.testing.assert_close(attn, attn2)
    # project_clip_taps after a gather == the projected output gathered
    idx = vis_idx(2, 2, 4, 2, 6)
    gz = tclip.project_clip_taps(tm, z[:, torch.arange(2)[:, None],
                                       torch.from_numpy(idx).long()])
    jg = jclip.project_clip_taps(p, jnp.take_along_axis(
        jz, jnp.asarray(idx)[None, :, :, None], axis=2))
    close(gz, jg)


def test_clip_teacher_refuses_wrong_raster():
    _, _, tm, _ = _clip_pair()
    with pytest.raises(ValueError, match="teacher expects 32x32"):
        tm(torch.zeros(1, 2, 48, 48, 3))


def _student_cfg():
    return dict(img_size=32, patch_size=16, encoder_embed_dim=128,
                encoder_depth=3, encoder_num_heads=2, num_frames=4,
                tubelet_size=1, clip_decoder_embed_dim=128,
                clip_output_dim=64, clip_return_layers=(0, 1))


@pytest.mark.parametrize("clip_only", [True, False])
def test_student_with_visible_tokens(clip_only):
    jm = jad.AdaptationVisionTransformer(**_student_cfg())
    x = videos(2, 4, 32, 7)
    idx = vis_idx(2, 4, 4, 2, 8)
    p = perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                        jnp.asarray(idx), False)["params"], 9)
    tm = load(tad.AdaptationVisionTransformer(**_student_cfg()),
              flax_to_state_dict(p))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(idx).long(),
                 clip_only=clip_only)
    ref = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(idx), clip_only)
    if clip_only:
        assert out.shape == (2, 2, 8, 64)
        close(out, ref)
    else:
        close(out[0], ref[0])
        close(out[1], ref[1])


def test_student_bridge_keys_match_torch_export():
    jm = jad.AdaptationVisionTransformer(**_student_cfg())
    x = videos(1, 4, 32, 0)
    p = jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                jnp.zeros((1, 8), jnp.int32), False)["params"]
    ours = flax_to_state_dict(p)
    theirs = flax_params_to_state(p)
    tm = tad.AdaptationVisionTransformer(**_student_cfg())
    assert set(ours) == set(theirs) == set(tm.state_dict())
    for k in ours:
        torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
        path, arr = torch_key_to_flax(k, ours[k].numpy())
        np.testing.assert_array_equal(arr, flatten(p)[path])


def test_clip_bridge_keys_invert_clip_key_to_flax():
    _, p, tm, _ = _clip_pair()
    state = flax_to_state_dict(p, kind="clip")
    assert set(state) == set(tm.state_dict())
    assert "transformer.resblocks.0.attn.in_proj_weight" in state
    assert "transformer.resblocks.2.mlp.c_fc.weight" in state
    flat = flatten(p)
    for k, v in state.items():
        path, arr = clip_key_to_flax(k, v.numpy())
        np.testing.assert_array_equal(arr, flat[path])
    assert len(state) == len(flat)
