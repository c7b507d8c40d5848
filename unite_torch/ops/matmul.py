"""Blocked matrix products: int8 (K7a) and bf16 (K7b), with plain versions.

Counterpart of tools/quant_kernel_probe.py's two Pallas kernels:

* ``int8_matmul(x8 [M, K], w8 [N, K]) -> int32 [M, N]`` (K7a, ``_mm_kernel``):
  int8 operands, int32 accumulation and output. Integer sums are exact for
  K up to 131071 (|acc| <= K*128^2 < 2^31), so the kernel equals its plain
  version bit for bit. It is the product inside ``ops.quant.int8_dense``,
  the int8 frozen teacher's dense layers.
* ``bf16_matmul(x [M, K], w [N, K]) -> bf16 [M, N]`` (K7b, ``_mm_bf16_kernel``):
  bf16 operands, fp32 accumulation, one rounding to bf16 at the end.

The weight is [N, K] (the port's Linear layout, K-contiguous, as the
tensor cores' row.col products want it), where the TPU kernels take
[K, N]; the probe (``unite_torch.tools.quant_kernel_probe``) keeps the
tool's [K, N] signature and transposes once. Both kernels are one
persistent wgmma body, csrc/blocked_matmul_wgmma.cu: any M and N, K a
multiple of 32 (int8) or 16 (bf16) on the card, where they raise
otherwise. The kernel writes its output tiles with TMA stores where an
output row is a multiple of 16 bytes, else with direct stores
(``store_route``). A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in
``.launches`` and by store route in ``.stores``; ``int8_matmul.by_shape``
counts them by (M, K, N).
"""

from __future__ import annotations

from collections import Counter

import torch

from unite_torch.ops import _build

# the largest K with K*128^2 < 2^31, so no int32 sum of int8 products can
# overflow (at 131072, 128 * 128 * K = 2^31 would wrap to -2^31); the card
# also needs K % 32 == 0, so its largest K is 131040
INT8_MAX_K = 131071
K_MULTIPLE = {torch.int8: 32, torch.bfloat16: 16}  # 32 bytes of K a step
OUT_DTYPE = {torch.int8: torch.int32, torch.bfloat16: torch.bfloat16}
TILES = ((128, 128), (128, 256), (256, 128))  # the kernel's tile shapes


def int8_matmul_reference(x8, w8):
    """Plain K7a: x8 [M, K] int8, w8 [N, K] int8 -> int32 [M, N], exact.
    On the CPU an int32 product; CUDA has no integer matmul, so there it is
    a float64 product (every product and partial sum is an integer below
    2^53) cast to int32."""
    if x8.device.type == "cpu":
        return x8.to(torch.int32) @ w8.to(torch.int32).T
    return (x8.double() @ w8.double().T).to(torch.int32)


def bf16_matmul_reference(x, w):
    """Plain K7b: x [M, K] bf16, w [N, K] bf16 -> bf16 [M, N], the fp32 sum
    of the products rounded once."""
    return (x.float() @ w.float().T).to(torch.bfloat16)


def bf16_tolerance(x, w, ref):
    """Elementwise bound on |K7b - plain K7b|: one bf16 ulp of |ref|, plus
    twice the fp32 rounding of a K-term sum (K*2^-24 of sum_k |x||w|): two
    fp32 summation orders differ by that, which exceeds an ulp only near
    zero."""
    k = x.shape[1]
    mag = ref.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ulp + 2.0 * k * 2.0 ** -24 * (x.float().abs() @ w.float().abs().T)


def _check(x, w, dtype, what: str):
    if x.dtype != dtype or w.dtype != dtype:
        raise TypeError(f"{what} takes {dtype} operands, got {x.dtype} and "
                        f"{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{what} takes x [M, K] and w [N, K], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"{what}: operands on {x.device} and {w.device}")


def _check_cuda(x, w, what: str):
    k, mult = x.shape[1], K_MULTIPLE[x.dtype]
    if k % mult:
        raise ValueError(f"{what}: K = {k} is not a multiple of {mult}; the "
                         "kernel steps through K 32 bytes at a time")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} takes contiguous operands with 16-byte "
                             f"aligned rows, got strides {t.stride()}")


def store_route(out_dtype, n: int) -> str:
    """How the kernel writes an output of ``n`` columns: "tma" (staged tiles
    stored by TMA, which needs a row pitch that is a multiple of 16 bytes:
    N % 4 == 0 for int32, N % 8 == 0 for bf16) or "direct" (masked stores
    from the registers). The kernel's host code makes the same choice."""
    return "tma" if n * out_dtype.itemsize % 16 == 0 else "direct"


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(fn, entry: str, x, w, tile):
    """Launch K7a or K7b through ``entry`` into a new output and count it;
    ``tile`` (bm, bn), one of ``TILES``, or None for the kernel's own."""
    (m, k), n = x.shape, w.shape[0]
    out = torch.empty((m, n), dtype=OUT_DTYPE[x.dtype], device=x.device)
    if not (m and n):
        return out
    lib = _build.load("blocked_matmul_wgmma")
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k)
    if tile is None:
        err = getattr(lib, entry)(*args, _stream(x))
    else:
        if tuple(tile) not in TILES:
            raise ValueError(f"{entry}: tile {tile} is not one of {TILES}")
        entry += "_tile"
        err = getattr(lib, entry)(*args, *tile, _stream(x))
    _build.check(err, entry)
    fn.launches += 1
    fn.stores[store_route(out.dtype, n)] += 1
    return out


def int8_matmul(x8, w8, tile=None):
    """K7a: x8 [M, K] int8, w8 [N, K] int8 -> int32 [M, N], exact for K up
    to ``INT8_MAX_K`` = 131071. On the card K must also be a multiple of
    32, so the largest K the kernel takes is 131040. ``tile`` (bm, bn)
    picks one of the kernel's tile shapes (for timing them); None takes
    its default."""
    _check(x8, w8, torch.int8, "int8_matmul")
    if x8.shape[1] > INT8_MAX_K:
        raise ValueError(f"int8_matmul: K = {x8.shape[1]} > {INT8_MAX_K} may "
                         "overflow the int32 sum")
    if x8.device.type == "cpu":
        return int8_matmul_reference(x8, w8)
    _check_cuda(x8, w8, "int8_matmul")
    out = _launch(int8_matmul, "unite_int8_matmul", x8, w8, tile)
    if out.numel():
        int8_matmul.by_shape[(x8.shape[0], x8.shape[1], w8.shape[0])] += 1
    return out


int8_matmul.launches = 0
int8_matmul.stores = Counter()
int8_matmul.by_shape = Counter()


def bf16_matmul(x, w, tile=None):
    """K7b: x [M, K] bf16, w [N, K] bf16 -> bf16 [M, N]; ``tile`` as in
    ``int8_matmul``."""
    _check(x, w, torch.bfloat16, "bf16_matmul")
    if x.device.type == "cpu":
        return bf16_matmul_reference(x, w)
    _check_cuda(x, w, "bf16_matmul")
    return _launch(bf16_matmul, "unite_bf16_matmul", x, w, tile)


bf16_matmul.launches = 0
bf16_matmul.stores = Counter()
