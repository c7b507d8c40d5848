"""The short-sequence attention forward (csrc/short_attn_wgmma.cu), which
serves K1 (packed qkv, lse2) and K5's forward ([B, H, S, D] views, m and l).

CPU cases check the build list, the C declarations and what the K1 and K5
wrappers hand the kernel's entry points (meta tensors stand in for CUDA
tensors: they take the wrappers' CUDA path and have addresses from 0).
Card cases hold the kernel against the plain versions over the lengths
around its 64-row tiles and 64-key chunks; they import no JAX, so run them
where only PyTorch is installed:

    python -m pytest tests/test_torch_port_short_attn.py --noconftest -q
"""

import ctypes
from types import SimpleNamespace

import pytest
import torch

import unite_torch.ops.attention as TA
from unite_torch.ops import _build

SCALE = 64 ** -0.5
# entry -> (arguments, integers after the strides: B, S, H and D)
ENTRIES = {"unite_short_qkv_fwd": (12, 4), "unite_short_grouped_fwd": (13, 4)}


def test_short_source_is_built_and_declared():
    assert "short_attn_wgmma" in _build.SOURCES
    text = (_build.CSRC / "short_attn_wgmma.cu").read_text()
    assert '#include "hopper.cuh"' in text
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in ENTRIES})
    _build._declare(lib)
    for name, (n, ints) in ENTRIES.items():
        assert f'extern "C" int {name}(' in text
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int
        assert len(fn.argtypes) == n
        # every pointer and the stream as a pointer, the strides as an array
        assert fn.argtypes[-1] is ctypes.c_void_p
        assert fn.argtypes[-2] is ctypes.c_float
        assert fn.argtypes[-2 - ints:-2] == [ctypes.c_int] * ints
        assert fn.argtypes[-3 - ints] is ctypes.POINTER(ctypes.c_longlong)


@pytest.fixture
def entry(monkeypatch):
    """Record the calls that reach the kernel's C entry points. The
    wrappers' launch counters start at 0 and are restored afterwards, so
    that no other test in the process sees these launches."""
    calls = []

    def load(name):
        return SimpleNamespace(**{
            e: (lambda *a, e=e: calls.append((name, e, a)) or 0)
            for e in ENTRIES})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(TA, "_stream", lambda t: 0)
    for fn in (TA.fused_qkv_fwd, TA.grouped_fwd):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("b,s,h", [(2, 197, 12), (3, 320, 16), (1, 768, 2)])
def test_k1_wrapper_passes_the_packed_lanes(entry, b, s, h, with_lse):
    qkv = torch.empty((b, s, 3 * h * 64), dtype=torch.bfloat16, device="meta")
    n0 = TA.fused_qkv_fwd.launches
    out, lse = TA.fused_qkv_fwd(qkv, h, SCALE, with_lse=with_lse)
    assert TA.fused_qkv_fwd.launches == n0 + 1
    assert out.shape == (b, s, h * 64) and out.is_contiguous()
    assert (lse is not None) == with_lse
    (lib, name, args), = entry
    assert (lib, name) == ("short_attn_wgmma", "unite_short_qkv_fwd")
    hd2 = h * 64 * 2  # bytes of one lane slice of a row
    assert args[:4] == (0, hd2, 2 * hd2, 0)  # q, k, v lanes of qkv; out
    assert args[4] == (0 if with_lse else None)
    width = 3 * h * 64
    assert tuple(args[5]) == (s * width, 64, width) * 3 + (s * h * 64, 64,
                                                           h * 64)
    assert args[6:10] == (b, s, h, 64)  # B, S, H, D
    assert args[10] == pytest.approx(SCALE * TA.INV_LN2)
    assert args[11] == 0


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "views"])
def test_k5_wrapper_passes_the_views(entry, layout, with_stats):
    b, s, h = 2, 392, 12
    if layout == "views":
        qkv = torch.empty((b, s, 3 * h * 64), dtype=torch.bfloat16,
                          device="meta")
        q, k, v = TA._split_heads(qkv, h)
    else:
        q, k, v = (torch.empty((b, h, s, 64), dtype=torch.bfloat16,
                               device="meta") for _ in range(3))
    n0 = TA.grouped_fwd.launches
    o, stats = TA.grouped_fwd(q, k, v, SCALE, with_stats=with_stats)
    assert TA.grouped_fwd.launches == n0 + 1
    assert o.shape == (b, h, s, 64)
    assert o.stride() == TA._empty_like_rows(q).stride()
    assert (stats is not None) == with_stats
    (lib, name, args), = entry
    assert (lib, name) == ("short_attn_wgmma", "unite_short_grouped_fwd")
    assert args[:4] == tuple(t.data_ptr() for t in (q, k, v, o))
    assert args[4:6] == ((0, 0) if with_stats else (None, None))
    want = sum((t.stride()[:3] for t in (q, k, v, o)), ())
    assert tuple(args[6]) == want
    assert args[7:11] == (b, s, h, 64)  # B, S, H, D
    assert args[11] == pytest.approx(SCALE * TA.INV_LN2)


def test_k5_wrapper_refuses_what_does_not_fit(entry):
    q = torch.empty((1, 2, TA.FUSED_QKV_MAX_SEQ + 1, 64),
                    dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="K6"):
        TA.grouped_fwd(q, q, q, SCALE)
    assert entry == []


# ------------------------------------------------------------------ card

SWEEP = [1, 7, 8, 9, 63, 64, 65, 127, 128, 129, 196, 197, 208, 255, 256, 257,
         314, 320, 384, 385, 392, 511, 512]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check_k1(qkv, heads):
    ref, ref_lse = TA.qkv_attention_reference(qkv, heads, SCALE)
    out, lse = TA.fused_qkv_fwd(qkv, heads, SCALE, with_lse=True)
    again, _ = TA.fused_qkv_fwd(qkv, heads, SCALE, with_lse=True)
    out_nl, none = TA.fused_qkv_fwd(qkv, heads, SCALE)
    assert none is None and bool(torch.isfinite(out).all())
    assert _err(out, ref) <= 1e-2
    assert _err(lse, ref_lse) <= 1e-3
    assert torch.equal(again, out) and torch.equal(out_nl, out)


def _check_k5(q, k, v):
    ref, ref_m, ref_l = TA.grouped_reference(q, k, v, scale=SCALE)
    out, (m, l) = TA.grouped_fwd(q, k, v, SCALE, with_stats=True)
    again, (m2, l2) = TA.grouped_fwd(q, k, v, SCALE, with_stats=True)
    out_ns, none = TA.grouped_fwd(q, k, v, SCALE)
    assert none is None and bool(torch.isfinite(out).all())
    assert out.stride() == TA._empty_like_rows(q).stride()
    assert _err(out, ref) <= 1e-2
    assert _err(m, ref_m) <= 1e-3
    assert ((l - ref_l).abs() / ref_l).max().item() <= 1e-4
    assert torch.equal(again, out) and torch.equal(out_ns, out)
    assert torch.equal(m2, m) and torch.equal(l2, l)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 12, 16])
@pytest.mark.parametrize("s", SWEEP)
def test_short_forward_lengths_on_card(cuda, s, heads):
    # K1 on packed qkv, K5 on contiguous tensors and on strided qkv views,
    # with and without statistics, repeating bit for bit
    gen = torch.Generator(device=cuda).manual_seed(7 * s + heads)
    qkv = torch.randn((2, s, 3 * heads * 64), generator=gen, device=cuda
                      ).to(torch.bfloat16)
    _check_k1(qkv, heads)
    views = TA._split_heads(qkv, heads)
    _check_k5(*views)
    _check_k5(*(t.contiguous() for t in views))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [197, 320, 392, 513, 768])
def test_short_forward_with_negative_scores_on_card(cuda, s):
    # k = -q: every real score of a row is negative, so zero-filled keys
    # past S (s = 0) would raise the row max if they entered it
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((2, s, 2, 64), generator=gen, device=cuda).abs()
    qkv = torch.cat([q, -q, torch.randn_like(q)], dim=2).reshape(
        2, s, 3 * 2 * 64).to(torch.bfloat16)
    _check_k1(qkv, 2)
    if s <= TA.GROUPED_MAX_SEQ:
        _check_k5(*(t.contiguous() for t in TA._split_heads(qkv, 2)))
