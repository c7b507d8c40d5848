"""unite_torch's int8 frozen teacher against unite_tpu's, on the CPU.

``ops.quant`` repeats unite_tpu/ops/quant.py's arithmetic in the same order,
so the quantizers and the int8 dense layer must equal JAX's bit for bit in
fp32 and in bf16. The plain versions of the blocked-matmul kernels (K7a
int8, K7b bf16) are held against the Pallas kernels of
tools/quant_kernel_probe.py run in interpret mode, and the quantized CLIP
tower against ``CLIPVisionTransformer(quantize=True)`` with weights from
``quantize_clip_params`` through the bridge.
"""

import functools
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.models import clip as jclip
from unite_tpu.ops import quant as jq
from unite_torch.models import clip as tclip
from unite_torch.models.layers import Linear
from unite_torch.ops import matmul as tmm
from unite_torch.ops import quant as tq
from unite_torch.tools import quant_kernel_probe as port_probe
from unite_torch.utils.flax_bridge import flax_to_state_dict

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


# ------------------------------------------------------------- the ops


def test_quantize_weight_matches_jax_bitwise():
    w = np.random.default_rng(0).standard_normal((96, 64)).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero output channel: the 1e-8 floor of the scale
    jw, js = jq.quantize_weight(jnp.asarray(w))  # [in, out]
    tw, ts = tq.quantize_weight(torch.from_numpy(w.T.copy()))  # [out, in]
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[5].item() == np.float32(np.float32(1e-8) / np.float32(127.0))
    assert not tw[5].any()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(5, 96), (3, 7, 96)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_dense_matches_jax_bitwise(dtype, shape, bias):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32) if bias else None
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 3).astype(jdt)
    jw, js = jq.quantize_weight(jnp.asarray(w))
    ref = jq.int8_dense(x, jw, js, None if b is None else jnp.asarray(b))
    tw, ts = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    out = tq.int8_dense(torch.from_numpy(f32(x)).to(tdt), tw, ts,
                        None if b is None else torch.from_numpy(b))
    assert out.dtype == tdt and tuple(out.shape) == shape[:-1] + (64,)
    np.testing.assert_array_equal(out.float().numpy(), f32(ref))


# ------------------------------------- K7 plain versions against Pallas


@pytest.fixture(scope="module")
def probe_tool():
    """tools/quant_kernel_probe.py with its pallas_call in interpret mode.
    Importing it sets two JAX options process-wide; they are put back."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "quant_kernel_probe_tool", ROOT / "tools" / "quant_kernel_probe.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    pl = mod.pl
    mod.pl = SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, CostEstimate=pl.CostEstimate)
    return mod


@pytest.mark.parametrize("m,k,n", [(256, 96, 256), (128, 768, 384)])
def test_int8_plain_matches_pallas_bitwise(probe_tool, m, k, n):
    rng = np.random.default_rng(m + k)
    x8 = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w8 = rng.integers(-128, 128, (k, n), dtype=np.int8)
    ref = np.asarray(probe_tool.int8_matmul(jnp.asarray(x8), jnp.asarray(w8),
                                            bm=128, bn=128))
    # the port's probe keeps the tool's [K, N] signature
    out = port_probe.int8_matmul(torch.from_numpy(x8), torch.from_numpy(w8))
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(256, 96, 256), (128, 768, 384)])
def test_bf16_plain_matches_pallas_within_an_ulp(probe_tool, m, k, n):
    rng = np.random.default_rng(m + k + 1)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    ref = f32(probe_tool.bf16_matmul(x, w, bm=128, bn=128))
    xt = torch.from_numpy(f32(x)).to(torch.bfloat16)
    out = port_probe.bf16_matmul(xt, torch.from_numpy(f32(w)).to(
        torch.bfloat16))
    wt = torch.from_numpy(f32(w).T.copy()).to(torch.bfloat16)  # [N, K]
    assert out.dtype == torch.bfloat16
    # both round one fp32 sum to bf16; the two sums differ by fp32 order
    # only, so the results lie within one bf16 ulp of |value| (plus the fp32
    # order term, which matters only near zero)
    err = np.abs(out.float().numpy() - ref)
    assert (err <= tmm.bf16_tolerance(xt, wt, out).numpy()).all()
    mag = np.maximum(np.abs(ref), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (err <= ulp).mean() > 0.999


def test_matmul_wrappers_check_their_operands():
    x8 = torch.zeros(4, 32, dtype=torch.int8)
    with pytest.raises(TypeError):
        tmm.int8_matmul(x8.float(), x8)
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        tmm.int8_matmul(x8, torch.zeros(32, 4, dtype=torch.int8)[:, :3])
    with pytest.raises(TypeError):
        tmm.bf16_matmul(x8, x8)
    with pytest.raises(ValueError, match="overflow"):
        big = torch.zeros(1, tmm.INT8_MAX_K + 32, dtype=torch.int8)
        tmm.int8_matmul(big, big)
    # the plain versions take any K; CUDA tensors take the kernels' rules
    a = torch.ones(3, 20, dtype=torch.bfloat16)
    assert tmm.bf16_matmul(a, a).float().eq(20.0).all()
    assert tmm.int8_matmul(torch.ones(3, 5, dtype=torch.int8),
                           torch.ones(2, 5, dtype=torch.int8)).eq(5).all()


# ---------------------------------------------------- the int8 teacher


def _clip_cfg(patch, res):
    return dict(input_resolution=res, patch_size=patch, width=128, layers=3,
                heads=2, output_dim=24, return_attn=True, return_index=(1, 2))


def _video(res, seed):
    return np.random.default_rng(seed).uniform(
        size=(2, 4, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("patch,res", [(16, 32), (14, 28)])
def test_quantized_clip_matches_jax(patch, res):
    cfg = _clip_cfg(patch, res)
    x = _video(res, 4)
    jm = jclip.CLIPVisionTransformer(**cfg)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 6)
    pq = jq.quantize_clip_params(p)
    jz, jattn = jclip.CLIPVisionTransformer(quantize=True, **cfg).apply(
        {"params": pq}, jnp.asarray(x), raw_taps=True)
    jzp, _ = jclip.CLIPVisionTransformer(quantize=True, **cfg).apply(
        {"params": pq}, jnp.asarray(x))

    state = flax_to_state_dict(pq, kind="clip", patch_size=patch)
    tm = tclip.CLIPVisionTransformer(quantize=True, **cfg)
    tm.load_state_dict(state, strict=True)
    tm.eval().requires_grad_(False)  # as the engine freezes the teacher
    with torch.no_grad():
        z, attn = tm(torch.from_numpy(x), raw_taps=True)
        zp, _ = tm(torch.from_numpy(x))
    # fp32 on both sides: the int8 products are exact and the rest differs
    # by summation order, 1e-5 of the taps' O(1)-O(10) scale (the models'
    # tolerance); no activation lands on another int8 level here
    np.testing.assert_allclose(z.numpy(), f32(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zp.numpy(), f32(jzp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), f32(jattn), rtol=1e-5, atol=1e-6)

    # quantize_clip_ on the port's own fp32 tower gives the same int8
    # weights and scales as quantize_clip_params, bit for bit
    tf = tclip.CLIPVisionTransformer(**cfg)
    tf.load_state_dict(flax_to_state_dict(p, kind="clip", patch_size=patch))
    mine = tq.quantize_clip_(tf).state_dict()
    assert set(mine) == set(state) == set(tm.state_dict())
    for k, v in state.items():
        assert mine[k].dtype == v.dtype, k
        assert torch.equal(mine[k], v), k
    assert state["transformer.resblocks.0.attn.in_proj_weight"].dtype \
        == torch.int8


def test_int8_teacher_close_to_its_fp32_teacher():
    # tests/test_quant.py's bounds, on the port's own pair
    cfg = _clip_cfg(14, 28)
    torch.manual_seed(0)
    fp = tclip.CLIPVisionTransformer(**cfg).eval()
    q = tclip.CLIPVisionTransformer(**cfg).eval()
    q.load_state_dict(fp.state_dict())
    tq.quantize_clip_(q).requires_grad_(False)
    x = torch.from_numpy(_video(28, 7))
    with torch.no_grad():
        z, attn = fp(x)
        zq, attnq = q(x)
    assert zq.shape == z.shape and attnq.shape == attn.shape
    cos = (z * zq).sum(-1)  # L2-normed taps
    assert cos.min().item() > 0.98
    tv = 0.5 * (attn - attnq).abs().sum(-1)
    assert tv.max().item() < 0.05
    assert not torch.equal(z, zq)  # the int8 path did run
    with pytest.raises(ValueError, match="already int8"):
        tq.quantize_clip_(q)


def test_quant_linear_keeps_int8_buffers():
    lin = Linear(64, 32)
    torch.nn.init.normal_(lin.bias)
    q = tq.QuantLinear.from_linear(lin)
    assert q.weight.dtype == torch.int8 and not isinstance(
        q.weight, torch.nn.Parameter)
    assert [n for n, _ in q.named_parameters()] == ["bias"]
    assert set(q.state_dict()) == {"weight", "weight_scale", "bias"}
    q.requires_grad_(False)  # an int8 Parameter would refuse this
    x = torch.randn(3, 64)
    ref = tq.int8_dense(x, *tq.quantize_weight(lin.weight), lin.bias)
    assert torch.equal(q(x), ref)
    rel = (q(x) - lin(x)).norm() / lin(x).norm()
    assert rel.item() < 2e-2  # tests/test_quant.py's int8 error bound


# ----------------------------------------------------------- the bridge


def test_bridge_maps_quantized_leaves_and_refuses_unknown_ones():
    cfg = dict(_clip_cfg(16, 32), layers=1, return_index=(0,))
    jm = jclip.CLIPVisionTransformer(**cfg)
    p = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 2, 32, 32, 3)))["params"]
    p = perturb(p, 2)
    pq = jq.quantize_clip_params(p)
    state = flax_to_state_dict(pq, kind="clip")
    attn = pq["resblocks_0"]["attn"]
    # each leaf on its own key: the scale and the int8 kernel no longer
    # overwrite the bias
    np.testing.assert_array_equal(
        state["transformer.resblocks.0.attn.in_proj_bias"].numpy(),
        attn["in_proj"]["bias"])
    np.testing.assert_array_equal(
        state["transformer.resblocks.0.attn.in_proj_weight"].numpy(),
        np.asarray(attn["in_proj"]["kernel_q"]).T)
    np.testing.assert_array_equal(
        state["transformer.resblocks.0.mlp.c_fc.weight_scale"].numpy(),
        np.asarray(pq["resblocks_0"]["mlp_c_fc"]["kernel_scale"]))
    np.testing.assert_array_equal(
        state["transformer.resblocks.0.mlp.c_fc.bias"].numpy(),
        pq["resblocks_0"]["mlp_c_fc"]["bias"])
    assert len(state) == len(jax.tree.leaves(pq))
    for name in tq.CLIP_QUANT_DENSE_NAMES:
        bad = jax.tree.map(lambda a: a, pq)
        blk = bad["resblocks_0"]
        node = blk[name] if name in blk else blk["attn"][name]
        node["kernel_zero_point"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="kernel_zero_point"):
            flax_to_state_dict(bad, kind="clip")
