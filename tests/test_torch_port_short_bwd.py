"""The short-sequence attention backward (csrc/short_bwd_wgmma.cu), which
serves K2 (packed qkv, from K1's lse2) and K5's backward ([B, H, S, D]
views, from the K5 forward's m and l).

CPU cases check the build list, the C declarations, the kernels' names and
what the K2 and K5 wrappers hand the kernel's entry points (meta tensors
stand in for CUDA tensors: they take the wrappers' CUDA path and have
addresses from 0). The plain versions are held against the Pallas kernels
in tests/test_torch_port_attention.py and tests/test_torch_port_grouped.py;
the card cases (``-k short_backward``) are in tests/test_torch_port_cuda.py.
"""

import ctypes
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import unite_torch.ops.attention as TA
from unite_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
SCALE = 64 ** -0.5
SOURCE = "short_bwd_wgmma"
# entry -> number of pointer arguments before the strides
ENTRIES = {"unite_short_qkv_bwd": 10, "unite_short_grouped_dq": 8,
           "unite_short_grouped_dkv": 9}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _text():
    return (_build.CSRC / f"{SOURCE}.cu").read_text()


def test_short_bwd_source_is_built_and_declared():
    assert SOURCE in _build.SOURCES
    assert SOURCE in _chip_smoke().WGMMA_SOURCES  # the smoke fails on a spill
    text = _text()
    assert '#include "hopper.cuh"' in text
    assert '#include "attn_bwd_wgmma.cuh"' in text
    assert "attn_bwd_wgmma.cuh" in _build.HEADERS  # a changed header rebuilds
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in ENTRIES})
    _build._declare(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, n in ENTRIES.items():
        assert f'extern "C" int {name}(' in text
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int
        # B, S, H, D, c, scale, the stream
        assert fn.argtypes == [p] * n + [ctypes.POINTER(ctypes.c_longlong),
                                         i, i, i, i, f, f, p]


def test_kernel_names_are_in_the_profiles_attention_class():
    # profile_step counts a kernel as attention by a part of its name
    text = _text()
    for kernel in ("short_attn_dq_wgmma_kernel(", "short_attn_dkv_wgmma_kernel("):
        assert kernel in text
    assert '"short_attn"' in (ROOT / "chip_smoke.py").read_text()


@pytest.mark.parametrize("name", ["flash_bwd_wgmma", "short_bwd_wgmma"])
def test_backwards_share_the_fragment_packing(name):
    # both backwards re-pack a rounded accumulator as A fragments through
    # the header's pack_pairs, and keep no copy of their own
    header = (_build.CSRC / "attn_bwd_wgmma.cuh").read_text()
    assert "void pack_pairs(" in header and "uint32_t bf2(" in header
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert "pack_pairs(" in text
    for helper in ("void pack_pairs(", "uint32_t bf2(", "void pack_a("):
        assert helper not in text, (name, helper)


@pytest.mark.parametrize("gone", ["fused_qkv_bwd", "grouped_attn_bwd"])
def test_mma_sync_backward_sources_are_gone(gone):
    assert gone not in _build.SOURCES
    assert not (_build.CSRC / f"{gone}.cu").exists()
    for entry in ("unite_fused_qkv_bwd", "unite_grouped_dq",
                  "unite_grouped_dkv"):
        for name in _build.SOURCES:
            assert f"int {entry}(" not in (_build.CSRC / f"{name}.cu"
                                           ).read_text(), (entry, name)


@pytest.fixture
def entry(monkeypatch):
    """Record the calls that reach the kernel's C entry points, with the
    wrappers' launch counters started at 0 and restored afterwards."""
    calls = []

    def load(name):
        return SimpleNamespace(**{
            e: (lambda *a, e=e: calls.append((name, e, a)) or 0)
            for e in ENTRIES})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(TA, "_stream", lambda t: 0)
    for fn in (TA.fused_qkv_bwd, TA.grouped_dq, TA.grouped_dkv):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("b,s,h", [(2, 197, 12), (3, 320, 16), (1, 768, 2)])
def test_k2_wrapper_passes_the_packed_lanes(entry, b, s, h):
    qkv, out, do = _meta(b, s, 3 * h * 64), _meta(b, s, h * 64), \
        _meta(b, s, h * 64)
    lse = _meta(b, h, s, dtype=torch.float32)
    dqkv = TA.fused_qkv_bwd(qkv, out, lse, do, h, SCALE)
    assert TA.fused_qkv_bwd.launches == 1
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.bfloat16
    (lib, name, args), = entry
    assert (lib, name) == (SOURCE, "unite_short_qkv_bwd")
    hd2 = h * 64 * 2  # bytes of one lane slice of a row
    # q, k, v lanes of qkv; out; do; dq, dk, dv lanes of dqkv; lse, delta
    assert args[:10] == (0, hd2, 2 * hd2, 0, 0, 0, hd2, 2 * hd2, 0, 0)
    width, hd = 3 * h * 64, h * 64
    assert tuple(args[10]) == ((s * width, 64, width) * 3
                               + (s * hd, 64, hd) * 2
                               + (s * width, 64, width) * 3)
    assert args[11:15] == (b, s, h, 64)  # B, S, H, D
    assert args[15] == pytest.approx(SCALE * TA.INV_LN2)  # c
    assert args[16] == pytest.approx(SCALE)
    assert args[17] == 0  # the stream


def _grouped_inputs(layout, b=2, s=392, h=12):
    if layout == "views":
        q, k, v = TA._split_heads(_meta(b, s, 3 * h * 64), h)
        do = TA._heads_of(_meta(b, s, h * 64), h)
    else:
        q, k, v, do = (_meta(b, h, s, 64) for _ in range(4))
    m, l, delta = (_meta(b, h, s, dtype=torch.float32) for _ in range(3))
    return q, k, v, do, m, l, delta


@pytest.mark.parametrize("layout", ["contiguous", "views"])
def test_k5_wrappers_pass_the_views(entry, layout):
    q, k, v, do, m, l, delta = _grouped_inputs(layout)
    dq, dk, dv = (TA._empty_like_rows(x) for x in (q, k, v))
    TA.grouped_dq(q, k, v, do, m, l, dq, delta, SCALE)
    TA.grouped_dkv(q, k, v, do, m, l, delta, dk, dv, SCALE)
    assert (TA.grouped_dq.launches, TA.grouped_dkv.launches) == (1, 1)
    (lib_q, name_q, aq), (lib_kv, name_kv, akv) = entry
    assert (lib_q, name_q) == (SOURCE, "unite_short_grouped_dq")
    assert (lib_kv, name_kv) == (SOURCE, "unite_short_grouped_dkv")
    views = tuple(t.data_ptr() for t in (q, k, v, do))
    stats = tuple(t.data_ptr() for t in (m, l, delta))
    assert aq[:8] == views + stats + (dq.data_ptr(),)
    assert akv[:9] == views + stats + (dk.data_ptr(), dv.data_ptr())
    assert tuple(aq[8]) == sum((t.stride()[:3] for t in (q, k, v, do, dq)),
                               ())
    assert tuple(akv[9]) == sum((t.stride()[:3]
                                 for t in (q, k, v, do, dk, dv)), ())
    b, h, s, d = q.shape
    for args, at in ((aq, 9), (akv, 10)):
        assert args[at:at + 4] == (b, s, h, d)  # B, S, H, D
        assert args[at + 4] == pytest.approx(SCALE * TA.INV_LN2)
        assert args[at + 5] == pytest.approx(SCALE)


def test_k5_backward_refuses_what_does_not_fit(entry):
    # a head's q, do and bf16(do/l) (q and do at head dim 80) fill the dk/dv
    # kernel's shared memory at 512 keys; the route sends longer sequences
    # to K6
    q, k, v, do, m, l, delta = _grouped_inputs("contiguous",
                                               s=TA.GROUPED_MAX_SEQ + 1)
    with pytest.raises(ValueError, match="K6"):
        TA.grouped_dq(q, k, v, do, m, l, torch.empty_like(q), delta, SCALE)
    with pytest.raises(ValueError, match="K6"):
        TA.grouped_dkv(q, k, v, do, m, l, delta, torch.empty_like(k),
                       torch.empty_like(v), SCALE)
    assert entry == []


def test_k2_refuses_beyond_its_guard(entry):
    b, s, h = 1, TA.FUSED_QKV_MAX_SEQ + 1, 2
    with pytest.raises(ValueError, match="K3"):
        TA.fused_qkv_bwd(_meta(b, s, 3 * h * 64), _meta(b, s, h * 64),
                         _meta(b, h, s, dtype=torch.float32),
                         _meta(b, s, h * 64), h, SCALE)
    assert entry == []
