"""unite_torch blocked flash attention (K6) and the attention route against
unite_tpu, on the CPU.

The JAX side runs ``_flash_fwd`` (``_fwd_kernel``) and the VJP of
``_flash_attention`` (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) with
``_INTERPRET`` and ``_on_tpu`` patched, emulated on the CPU, at lengths with
no divisor query block (521, 577, 785): the queries pad to a multiple of
128 there, and the padded rows must not leak. The port's CPU path is the
kernels' plain versions. Tolerances as for K3/K4: 1e-5 in fp32 (summation
order), 2e-2 absolute in bf16 on values scaled to at most 1 (the two
packages round p at the same points; a bf16 ulp of a value near 1 is 4e-3
and the sums differ in order). The CUDA kernels are held against these
plain versions on the card by tests/test_torch_port_cuda.py.

The models: a CLS student over 4 frames of 224^2 (784 patches + CLS = 785
tokens, no divisor block) and the CLS ViT take K6 on the port and match the
JAX forward in fp32; the route predicate equals JAX's ``use_fused_qkv``
for every length from 1 to 2048.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu.ops.attention as A
import unite_torch.ops.attention as TA
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.models import vit as jvit
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.models import vit as tvit
from unite_torch.utils.flax_bridge import flax_to_state_dict

HEADS, SCALE = 2, 64 ** -0.5
DTYPES = [("float32", dict(rtol=1e-5, atol=1e-5)),
          ("bfloat16", dict(rtol=0, atol=2e-2))]
FLASH_COUNTERS = ("flash_fwd", "flash_dq", "flash_dkv")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(A, "_on_tpu", lambda: True)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jdt(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _tdt(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _torch(x, dtype):
    return torch.from_numpy(_np(x)).to(_tdt(dtype))


def _scaled(a, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    return a / scale, ref / scale


def _qkv(s, seed, dtype):
    return [jnp.asarray(_rand((1, HEADS, s, 64), seed + i)).astype(_jdt(dtype))
            for i in range(3)]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", [521, 577, 785])
def test_plain_k6_forward_matches_pallas(interpret, s, dtype, tol):
    q, k, v = _qkv(s, s, dtype)
    out, lse, _ = A._flash_fwd(q, k, v, SCALE, A.DEFAULT_BLOCK_Q)
    tout, tlse = TA.flash_fwd(*(_torch(x, dtype) for x in (q, k, v)), SCALE,
                              with_lse=True)
    assert tout.shape == (1, HEADS, s, 64) and tlse.shape == (1, HEADS, s)
    assert tout.dtype == _tdt(dtype)
    # the TPU pads the queries to 640 / 896 and broadcasts lse over 8 lanes
    np.testing.assert_allclose(tout.float().numpy()[0],
                               _np(out)[:HEADS, :s], **tol)
    np.testing.assert_allclose(tlse.numpy()[0], _np(lse)[:HEADS, :s, 0],
                               rtol=1e-5, atol=1e-5 if dtype == "float32"
                               else 1e-3)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", [521, 577, 785])
def test_plain_k6_backward_matches_pallas(interpret, s, dtype, tol):
    q, k, v = _qkv(s, 10 + s, dtype)
    g = jnp.asarray(_rand((1, HEADS, s, 64), 20 + s)).astype(_jdt(dtype))
    out, vjp = jax.vjp(lambda *a: A._flash_attention(*a, SCALE, 128, 128),
                       q, k, v)
    refs = vjp(g)
    _, lse, _ = A._flash_fwd(q, k, v, SCALE, A.DEFAULT_BLOCK_Q)
    # the same o and lse on both sides
    got = TA.flash_reference_bwd(
        *(_torch(x, dtype) for x in (q, k, v, out)),
        torch.from_numpy(_np(lse)[None, :HEADS, :s, 0]), _torch(g, dtype),
        scale=SCALE)
    for name, a, ref in zip("qkv", got, refs):
        assert a.dtype == _tdt(dtype), name
        np.testing.assert_allclose(*_scaled(a.float().numpy(), _np(ref)),
                                   err_msg=f"d{name}", **tol)


def test_plain_k6_is_the_gradient_in_fp32():
    # fp32: the rounding points are no-ops, so plain K6's backward is
    # autograd's gradient of plain attention up to summation order
    q, k, v = (torch.from_numpy(_rand((2, 3, 70, 64), i)) for i in range(3))
    g = torch.from_numpy(_rand((2, 3, 70, 64), 3))
    o, lse = TA.flash_reference(q, k, v, scale=SCALE)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = TA.attention_reference(*leaves, scale=SCALE)
    torch.testing.assert_close(o, ref.detach(), rtol=1e-5, atol=1e-5)
    ref.backward(g)
    for a, leaf in zip(TA.flash_reference_bwd(q, k, v, o, lse, g,
                                              scale=SCALE), leaves):
        torch.testing.assert_close(a, leaf.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_multi_head_attention_matches_jax_at_577(interpret, dtype, tol):
    # the public op: forward and VJP through K6 on both sides, and no
    # counter moves on the CPU
    q, k, v = _qkv(577, 40, dtype)
    g = jnp.asarray(_rand((1, HEADS, 577, 64), 44)).astype(_jdt(dtype))
    out, vjp = jax.vjp(lambda *a: A.multi_head_attention(
        *a, scale=SCALE, use_pallas=True), q, k, v)
    refs = vjp(g)
    before = [getattr(TA, n).launches for n in FLASH_COUNTERS]
    leaves = [_torch(x, dtype).requires_grad_(True) for x in (q, k, v)]
    tout = TA.multi_head_attention(*leaves, scale=SCALE)
    np.testing.assert_allclose(tout.detach().float().numpy(), _np(out),
                               **tol)
    tout.backward(_torch(g, dtype))
    for leaf, ref in zip(leaves, refs):
        np.testing.assert_allclose(
            *_scaled(leaf.grad.float().numpy(), _np(ref)), **tol)
    assert [getattr(TA, n).launches for n in FLASH_COUNTERS] == before


def test_multi_head_attention_short_probs_and_dropout():
    q, k, v = (torch.from_numpy(_rand((2, 2, 40, 64), 50 + i))
               for i in range(3))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    out = TA.multi_head_attention(q, k, v)  # S <= 512 on the CPU: plain
    np.testing.assert_allclose(out.numpy(), _np(A.attention_xla(jq, jk, jv)),
                               rtol=1e-5, atol=1e-5)
    out, probs = TA.multi_head_attention(q, k, v, scale=0.1,
                                         return_probs=True)
    ref, ref_probs = A.attention_xla(jq, jk, jv, scale=0.1, return_probs=True)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), _np(ref_probs), rtol=1e-5,
                               atol=1e-6)
    # dropout: only when not deterministic; keeps the mean of p.v
    gen = torch.Generator().manual_seed(0)
    same = TA.multi_head_attention(q, k, v, dropout_rate=0.5, generator=gen)
    torch.testing.assert_close(same, TA.multi_head_attention(q, k, v))
    dropped = TA.multi_head_attention(q, k, v, dropout_rate=0.5,
                                      generator=gen, deterministic=False)
    assert not torch.allclose(dropped, same)


@pytest.mark.parametrize("fwd_only", [False, True])
@pytest.mark.parametrize("dim", [None, 768, 832])
def test_route_predicate_equals_jax(fwd_only, dim):
    for s in range(1, 2049):
        assert TA.use_fused_qkv(s, fwd_only, dim) == A.use_fused_qkv(
            s, True, fwd_only=fwd_only, dim=dim), (s, fwd_only, dim)
    assert TA.packed_flash_ok(1568) and TA.packed_flash_ok(600)
    assert not any(TA.packed_flash_ok(s) for s in (513, 577, 785, 1569))
    assert sum(not TA.packed_flash_ok(s) for s in range(513, 2049)) == 1436


# --------------------------------------------------------------- models


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _count_k6(monkeypatch):
    calls = []
    fwd = TA.flash_fwd
    monkeypatch.setattr(TA, "flash_fwd", lambda *a, **k: (
        calls.append(1), fwd(*a, **k))[1])
    return calls


CLS_STUDENT = dict(img_size=224, patch_size=16, encoder_embed_dim=128,
                   encoder_depth=2, encoder_num_heads=2, num_frames=4,
                   tubelet_size=1, clip_decoder_embed_dim=128,
                   clip_output_dim=64, clip_return_layers=(0, 1),
                   use_cls_token=True)


@pytest.mark.parametrize("learnable_pos", [False, True])
def test_cls_student_takes_k6_and_matches_jax(monkeypatch, learnable_pos):
    cfg = dict(CLS_STUDENT, use_learnable_pos_emb=learnable_pos)
    sj = jad.AdaptationVisionTransformer(**cfg)
    x = _rand((2, 4, 224, 224, 3), 60)
    sp = perturb(sj.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"],
                 61)
    sm = tad.AdaptationVisionTransformer(**cfg)
    sm.load_state_dict(flax_to_state_dict(sp), strict=True)
    assert sm.encoder.cls_token.shape == (1, 1, 128)
    assert sm.encoder.pos_embed.shape == (1, 785, 128)
    calls = _count_k6(monkeypatch)
    ref_vis, ref_clip = sj.apply({"params": sp}, jnp.asarray(x), None, False,
                                 True)
    with torch.no_grad():
        x_vis, x_clip = sm.eval()(torch.from_numpy(x))
    assert len(calls) == 2  # one K6 forward a block at 785 tokens
    assert x_vis.shape == (2, 785, 128) and x_clip.shape == (2, 2, 784, 64)
    np.testing.assert_allclose(x_vis.numpy(), _np(ref_vis), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x_clip.numpy(), _np(ref_clip), rtol=1e-5,
                               atol=1e-5)
    # masked: CLS stays outside the gather (1 + 4*49 tokens, K1/K2 range)
    rng = np.random.default_rng(62)
    idx = np.stack([np.sort(np.concatenate(
        [f * 196 + rng.choice(196, 49, replace=False) for f in range(4)]))
        for _ in range(2)]).astype(np.int32)
    ref = sj.apply({"params": sp}, jnp.asarray(x), jnp.asarray(idx), True,
                   True)
    with torch.no_grad():
        got = sm(torch.from_numpy(x), torch.from_numpy(idx).long(),
                 clip_only=True)
    assert got.shape == (2, 2, 196, 64) and len(calls) == 2
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


def test_cls_vit_takes_k6_and_matches_jax(monkeypatch):
    cfg = dict(img_size=224, patch_size=16, num_classes=12, embed_dim=128,
               depth=2, num_heads=2, all_frames=4, tubelet_size=1,
               init_scale=0.001, use_mean_pooling=False)
    jm = jvit.VisionTransformer(**cfg)
    x = _rand((2, 4, 224, 224, 3), 70)
    p = perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(x[:1]))["params"],
                71)
    tm = tvit.VisionTransformer(**cfg)
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    calls = _count_k6(monkeypatch)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    assert len(calls) == 2
    np.testing.assert_allclose(out.numpy(), _np(jm.apply({"params": p},
                                                         jnp.asarray(x), True)),
                               rtol=1e-5, atol=1e-5)


def test_clip_image_encoder_mode_matches_jax():
    cfg = dict(input_resolution=32, patch_size=16, width=128, layers=2,
               heads=2, output_dim=64, return_attn=True, return_index=(0,))
    tj = jclip.CLIPVisionTransformer(**cfg)
    x = _rand((2, 3, 32, 32, 3), 80)
    tp = perturb(tj.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 81)
    tm = tclip.CLIPVisionTransformer(**cfg)
    tm.load_state_dict(flax_to_state_dict(tp, kind="clip"), strict=True)
    ref = tj.apply({"params": tp}, jnp.asarray(x), None, True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), cls_features=True)
    assert got.shape == (6, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_forward_kernel_builds_from_the_wgmma_source(monkeypatch):
    # K3 and K6 launch unite_flash_fwd from csrc/flash_fwd_wgmma.cu (with
    # the Hopper header); the short-sequence source holds the K1 and K5
    # forward entries, and the mma.sync forward sources are gone
    from types import SimpleNamespace

    from unite_torch.ops import _build

    assert "flash_fwd_wgmma" in _build.SOURCES
    assert "hopper.cuh" in _build.HEADERS
    for part in [f"{n}.cu" for n in _build.SOURCES] + list(_build.HEADERS):
        assert (_build.CSRC / part).is_file(), part
    entry = 'extern "C" int unite_flash_fwd('
    assert entry in (_build.CSRC / "flash_fwd_wgmma.cu").read_text()
    short = (_build.CSRC / "short_attn_wgmma.cu").read_text()
    assert "unite_flash_fwd" not in short
    assert 'extern "C" int unite_short_grouped_fwd(' in short
    for gone in ("packed_flash_fwd", "fused_qkv_fwd"):
        assert gone not in _build.SOURCES
        assert not (_build.CSRC / f"{gone}.cu").exists()
    lib = SimpleNamespace(unite_flash_fwd=SimpleNamespace())
    _build._declare(lib)
    assert lib.unite_flash_fwd.restype is ctypes.c_int
    assert len(lib.unite_flash_fwd.argtypes) == 12
    calls = []

    def load(name):
        return SimpleNamespace(unite_flash_fwd=lambda *a: calls.append(
            (name, a)) or 0)

    monkeypatch.setattr(_build, "load", load)
    strides = TA._strides_arg((1,) * 12)
    TA._launch_fwd([16, 32, 48, 64], strides, None, (1, 2, 3, 80), 0.125, 0)
    (name, args), = calls
    assert name == "flash_fwd_wgmma"
    assert args[:6] == (16, 32, 48, 64, None, strides)
    assert args[6:10] == (1, 3, 2, 80)  # B, S, H, D
    np.testing.assert_allclose(args[10], 0.125 * TA.INV_LN2)


# ------------------------------------------------- the backward's C entries

BWD_ENTRIES = ("unite_flash_dq", "unite_flash_dkv")
BWD_COUNTERS = ("packed_flash_dq", "packed_flash_dkv", "flash_dq",
                "flash_dkv")


def test_backward_kernels_build_from_the_wgmma_source():
    # K4a/K4b and K6's dq and dk/dv launch the two entries of
    # csrc/flash_bwd_wgmma.cu (with the Hopper header); the mma.sync source
    # is gone, and no other source declares them
    from types import SimpleNamespace

    from unite_torch.ops import _build

    assert "flash_bwd_wgmma" in _build.SOURCES
    assert "packed_flash_bwd" not in _build.SOURCES
    assert not (_build.CSRC / "packed_flash_bwd.cu").exists()
    text = (_build.CSRC / "flash_bwd_wgmma.cu").read_text()
    assert '#include "hopper.cuh"' in text
    # the profile's attention class matches the kernels' names
    assert "flash_dq_wgmma_kernel(" in text and "flash_dkv_wgmma_kernel(" in text
    for name in BWD_ENTRIES:
        assert f'extern "C" int {name}(' in text
        others = [n for n in _build.SOURCES if n != "flash_bwd_wgmma"
                  and name in (_build.CSRC / f"{n}.cu").read_text()]
        assert others == [], (name, others)
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in BWD_ENTRIES})
    _build._declare(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in BWD_ENTRIES:
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int
        assert fn.argtypes[:8] == [p] * 8  # 6 views, lse, delta
        # B, S, H, D, c, scale, stream
        assert fn.argtypes[9:] == [i, i, i, i, f, f, p]


@pytest.fixture
def bwd_entry(monkeypatch):
    """Record the calls that reach the backward's C entries, with the
    wrappers' counters started afresh."""
    from types import SimpleNamespace

    from unite_torch.ops import _build

    calls = []

    def load(name):
        return SimpleNamespace(**{
            e: (lambda *a, e=e: calls.append((name, e, a)) or 0)
            for e in BWD_ENTRIES})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(TA, "_stream", lambda t: 7)
    for name in BWD_COUNTERS:
        monkeypatch.setattr(getattr(TA, name), "launches", 0)
    return calls


def _arena(dtype):
    """Slices of one meta buffer: tensors that take no memory, each with
    its own data pointer."""
    buf = torch.empty(1 << 30, dtype=dtype, device="meta")
    at = [64]

    def take(*shape):
        n = int(np.prod(shape))
        t = buf[at[0]:at[0] + n].view(*shape)
        at[0] += n + 64
        return t
    return take


def _check_call(call, entry, ptrs, strides, b, s, h, d=64):
    lib, name, args = call
    assert (lib, name) == ("flash_bwd_wgmma", entry)
    assert args[:8] == tuple(ptrs)
    assert list(args[8]) == list(strides)
    assert args[9:13] == (b, s, h, d)
    assert args[13:] == (SCALE * TA.INV_LN2, SCALE, 7)  # c, scale, stream


@pytest.mark.parametrize("b,s,h", [(8, 1568, 12), (2, 600, 3)])
def test_packed_backward_passes_the_lane_slices(bwd_entry, b, s, h):
    # K4a and K4b: q, k, v are the lane slices of qkv, o and do those of
    # out and do, and dq, dk, dv those of dqkv, with the packed strides
    bf, f32 = _arena(torch.bfloat16), _arena(torch.float32)
    hd = h * 64
    qkv, dqkv = bf(b, s, 3 * hd), bf(b, s, 3 * hd)
    out, do = bf(b, s, hd), bf(b, s, hd)
    lse, delta = f32(b, h, s), f32(b, h, s)

    def lanes(t, *parts):
        return [t.data_ptr() + 2 * i * hd for i in parts]

    wide, narrow = (s * 3 * hd, 64, 3 * hd), (s * hd, 64, hd)
    TA.packed_flash_dq(qkv, out, lse, do, dqkv, delta, h, SCALE)
    TA.packed_flash_dkv(qkv, do, lse, delta, dqkv, h, SCALE)
    dq, dkv = bwd_entry
    _check_call(dq, "unite_flash_dq",
                lanes(qkv, 0, 1, 2) + [out.data_ptr(), do.data_ptr(),
                                       lse.data_ptr(), delta.data_ptr()]
                + lanes(dqkv, 0), wide * 3 + narrow * 2 + wide, b, s, h)
    _check_call(dkv, "unite_flash_dkv",
                lanes(qkv, 0, 1, 2) + [do.data_ptr(), lse.data_ptr(),
                                       delta.data_ptr()] + lanes(dqkv, 1, 2),
                wide * 3 + narrow + wide * 2, b, s, h)
    assert (TA.packed_flash_dq.launches, TA.packed_flash_dkv.launches,
            TA.flash_dq.launches, TA.flash_dkv.launches) == (1, 1, 0, 0)
    # the full backward: dq first, then dk/dv from the delta it wrote
    bwd_entry.clear()
    TA.packed_flash_bwd(qkv, out, lse, do, h, SCALE)
    (_, e0, a0), (_, e1, a1) = bwd_entry
    assert (e0, e1) == BWD_ENTRIES and a0[6] == a1[5]
    assert (TA.packed_flash_dq.launches, TA.packed_flash_dkv.launches) == (2, 2)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("b,s,h", [(5, 1569, 12), (40, 577, 16)])
def test_flash_backward_passes_the_views(bwd_entry, strided, b, s, h):
    # K6 dq and dk/dv: each view's pointer and (batch, head, row) strides,
    # on contiguous tensors and on the strided views of a qkv projection
    bf, f32 = _arena(torch.bfloat16), _arena(torch.float32)
    if strided:
        q, k, v = TA._split_heads(bf(b, s, 3 * h * 64), h)
        o, do, dq, dk, dv = (bf(b, s, h, 64).transpose(1, 2)
                             for _ in range(5))
    else:
        q, k, v, o, do, dq, dk, dv = (bf(b, h, s, 64) for _ in range(8))
    lse, delta = f32(b, h, s), f32(b, h, s)

    def args(*views):
        return ([t.data_ptr() for t in views],
                [x for t in views for x in t.stride()[:3]])

    TA.flash_dq(q, k, v, o, do, lse, dq, delta, SCALE)
    TA.flash_dkv(q, k, v, do, lse, delta, dk, dv, SCALE)
    call_dq, call_dkv = bwd_entry
    p, st = args(q, k, v, o, do, dq)
    _check_call(call_dq, "unite_flash_dq",
                p[:5] + [lse.data_ptr(), delta.data_ptr(), p[5]], st, b, s, h)
    p, st = args(q, k, v, do, dk, dv)
    _check_call(call_dkv, "unite_flash_dkv",
                p[:4] + [lse.data_ptr(), delta.data_ptr()] + p[4:], st, b, s,
                h)
    assert (TA.flash_dq.launches, TA.flash_dkv.launches,
            TA.packed_flash_dq.launches, TA.packed_flash_dkv.launches) == (
                1, 1, 0, 0)
    # flash_bwd: the outputs laid out as their inputs, one delta between
    bwd_entry.clear()
    TA.flash_bwd(q, k, v, o, lse, do, SCALE)
    (_, e0, a0), (_, e1, a1) = bwd_entry
    assert (e0, e1) == BWD_ENTRIES and a0[6] == a1[5]
    assert list(a0[8])[15:] == list(TA._empty_like_rows(q).stride()[:3])
    assert (TA.flash_dq.launches, TA.flash_dkv.launches) == (2, 2)
