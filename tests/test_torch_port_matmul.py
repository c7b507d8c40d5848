"""The blocked matmuls K7a (int8) and K7b (bf16): the int8 product's K
guard, the build list and C declarations of csrc/blocked_matmul_wgmma.cu,
and what the wrappers hand the kernel's entry points (meta tensors stand in
for CUDA tensors: they take the wrappers' CUDA path and have addresses from
0). The plain versions against the Pallas kernels are in
test_torch_port_quant.py, the kernels against the plain versions on the
card in test_torch_port_cuda.py.
"""

import ctypes
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from unite_torch.ops import _build
from unite_torch.ops import matmul as MM

ENTRIES = {"unite_int8_matmul": 7, "unite_bf16_matmul": 7,
           "unite_int8_matmul_tile": 9, "unite_bf16_matmul_tile": 9}


def test_int8_guard_admits_the_largest_exact_k():
    # |sum| <= K * 128^2 must stay below 2^31 for the int32 sum to be exact
    assert MM.INT8_MAX_K * 128 * 128 < 2 ** 31 <= (MM.INT8_MAX_K + 1) * 128 ** 2
    x = torch.full((1, MM.INT8_MAX_K), -128, dtype=torch.int8)
    out = MM.int8_matmul(x, x)
    assert out.dtype == torch.int32
    assert out.item() == 131071 * 128 * 128 == 2147467264


def test_int8_guard_refuses_a_k_that_may_overflow():
    x = torch.full((1, MM.INT8_MAX_K + 1), -128, dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        MM.int8_matmul(x, x)


def test_wgmma_source_is_built_and_declared():
    assert "blocked_matmul_wgmma" in _build.SOURCES
    assert "blocked_matmul" not in _build.SOURCES
    assert not (_build.CSRC / "blocked_matmul.cu").exists()
    text = (_build.CSRC / "blocked_matmul_wgmma.cu").read_text()
    assert '#include "hopper.cuh"' in text
    # the profile's "blocked matmul (K7)" class matches the kernel's name
    assert "__global__ void __launch_bounds__(THREADS, 1)\n" \
           "    blocked_matmul_wgmma_kernel(" in text
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in ENTRIES})
    _build._declare(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, n in ENTRIES.items():
        assert f'extern "C" int {name}(' in text
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int
        assert fn.argtypes[:3] == [p, p, p]  # x, w, out
        assert fn.argtypes[3:n - 1] == [i] * (n - 4)  # M, N, K (bm, bn)
        assert fn.argtypes[-1] is p  # the stream
        assert len(fn.argtypes) == n


@pytest.mark.parametrize("dtype,n,route", [
    (torch.int32, 4, "tma"), (torch.int32, 3072, "tma"),
    (torch.int32, 6, "direct"), (torch.int32, 257, "direct"),
    (torch.bfloat16, 8, "tma"), (torch.bfloat16, 2304, "tma"),
    (torch.bfloat16, 12, "direct"), (torch.bfloat16, 257, "direct")])
def test_store_route_needs_16_byte_rows(dtype, n, route):
    assert MM.store_route(dtype, n) == route


@pytest.fixture
def entry(monkeypatch):
    """Record the calls that reach the kernel's C entry points, and start
    the wrappers' counters afresh."""
    calls = []

    def load(name):
        return SimpleNamespace(**{
            e: (lambda *a, e=e: calls.append((name, e, a)) or 0)
            for e in ENTRIES})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(MM, "_stream", lambda t: 7)
    for fn in (MM.int8_matmul, MM.bf16_matmul):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "stores", Counter())
    monkeypatch.setattr(MM.int8_matmul, "by_shape", Counter())
    return calls


def _operands(dtype, m, k, n):
    return (torch.empty((m, k), dtype=dtype, device="meta"),
            torch.empty((n, k), dtype=dtype, device="meta"))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 32, 8), (130, 96, 257), (37824, 1024,
                                                                 3072),
                                   (37824, 4096, 1024), (5, 800, 12)])
def test_wrapper_passes_the_operands(entry, dtype, m, k, n):
    x, w = _operands(dtype, m, k, n)
    fn = MM.int8_matmul if dtype == torch.int8 else MM.bf16_matmul
    out = fn(x, w)
    assert out.shape == (m, n) and out.dtype == MM.OUT_DTYPE[dtype]
    (lib, name, args), = entry
    assert lib == "blocked_matmul_wgmma"
    assert name == ("unite_int8_matmul" if dtype == torch.int8
                    else "unite_bf16_matmul")
    assert args == (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, 7)
    assert fn.launches == 1
    route = MM.store_route(out.dtype, n)
    assert fn.stores == Counter({route: 1})
    if dtype == torch.int8:
        assert MM.int8_matmul.by_shape == Counter({(m, k, n): 1})
    assert MM.int8_matmul.launches + MM.bf16_matmul.launches == 1


@pytest.mark.parametrize("tile", MM.TILES)
def test_wrapper_passes_the_tile(entry, tile):
    x, w = _operands(torch.int8, 300, 1024, 1024)
    out = MM.int8_matmul(x, w, tile=tile)
    (_, name, args), = entry
    assert name == "unite_int8_matmul_tile"
    assert args == (x.data_ptr(), w.data_ptr(), out.data_ptr(), 300, 1024,
                    1024, *tile, 7)
    assert MM.int8_matmul.launches == 1
    xb, wb = _operands(torch.bfloat16, 300, 1024, 1024)
    MM.bf16_matmul(xb, wb, tile=tile)
    assert entry[1][1] == "unite_bf16_matmul_tile"
    assert entry[1][2][6:8] == tile


def test_wrapper_refuses_an_unknown_tile(entry):
    x, w = _operands(torch.int8, 300, 1024, 1024)
    with pytest.raises(ValueError, match="tile"):
        MM.int8_matmul(x, w, tile=(64, 64))
    assert entry == [] and MM.int8_matmul.launches == 0


@pytest.mark.parametrize("m,n", [(0, 8), (4, 0)])
def test_empty_output_launches_nothing(entry, m, n):
    x, w = _operands(torch.int8, m, 32, n)
    assert MM.int8_matmul(x, w).shape == (m, n)
    assert entry == [] and MM.int8_matmul.launches == 0
    assert MM.int8_matmul.by_shape == Counter()


def test_card_rules_raise_before_the_launch(entry):
    x, w = _operands(torch.int8, 4, 48, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        MM.int8_matmul(x, w)  # no plain fallback for a CUDA tensor
    x, w = _operands(torch.bfloat16, 4, 24, 8)
    with pytest.raises(ValueError, match="multiple of 16"):
        MM.bf16_matmul(x, w)
    x = torch.empty((8, 64), dtype=torch.int8, device="meta")[:, :32]
    with pytest.raises(ValueError, match="contiguous"):
        MM.int8_matmul(x, x)
    assert entry == []


def test_cpu_tensors_take_the_plain_version(entry):
    x = torch.randint(-128, 128, (5, 64), dtype=torch.int8)
    w = torch.randint(-128, 128, (3, 64), dtype=torch.int8)
    assert torch.equal(MM.int8_matmul(x, w), MM.int8_matmul_reference(x, w))
    assert torch.equal(MM.bf16_matmul(x.bfloat16(), w.bfloat16()),
                       MM.bf16_matmul_reference(x.bfloat16(), w.bfloat16()))
    assert entry == [] and MM.int8_matmul.launches == 0
