"""Blocked matrix products: int8 (K7a) and bf16 (K7b), with plain versions.

Counterpart of tools/quant_kernel_probe.py's two Pallas kernels:

* ``int8_matmul(x8 [M, K], w8 [N, K]) -> int32 [M, N]`` (K7a, ``_mm_kernel``):
  int8 operands, int32 accumulation and output. Integer sums are exact for
  K up to 131072 (|acc| <= K*128^2 < 2^31), so the kernel equals its plain
  version bit for bit. It is the product inside ``ops.quant.int8_dense``,
  the int8 frozen teacher's dense layers.
* ``bf16_matmul(x [M, K], w [N, K]) -> bf16 [M, N]`` (K7b, ``_mm_bf16_kernel``):
  bf16 operands, fp32 accumulation, one rounding to bf16 at the end.

The weight is [N, K] (the port's Linear layout, K-contiguous, as the
tensor cores' row.col products want it), where the TPU kernels take
[K, N]; the probe (``unite_torch.tools.quant_kernel_probe``) keeps the
tool's [K, N] signature and transposes once. Both kernels are
csrc/blocked_matmul.cu: any M and N, K a multiple of 32 (int8) or 16 (bf16)
on the card, where they raise otherwise. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches in ``.launches``; ``int8_matmul.by_shape`` counts them by
(M, K, N).
"""

from __future__ import annotations

from collections import Counter

import torch

from unite_torch.ops import _build

INT8_MAX_K = 131072  # K*128^2 < 2^31: the int32 sum cannot overflow
K_MULTIPLE = {torch.int8: 32, torch.bfloat16: 16}  # 32 bytes of K a step


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


def _launch(entry: str, x, w, out):
    m, k = x.shape
    n = w.shape[0]
    err = getattr(_build.load("blocked_matmul"), entry)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)


def int8_matmul(x8, w8):
    """K7a: x8 [M, K] int8, w8 [N, K] int8 -> int32 [M, N]."""
    _check(x8, w8, torch.int8, "int8_matmul")
    if x8.shape[1] > INT8_MAX_K:
        raise ValueError(f"int8_matmul: K = {x8.shape[1]} > {INT8_MAX_K} may "
                         "overflow the int32 sum")
    if x8.device.type == "cpu":
        return int8_matmul_reference(x8, w8)
    _check_cuda(x8, w8, "int8_matmul")
    (m, k), n = x8.shape, w8.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=x8.device)
    if m and n:
        _launch("unite_int8_matmul", x8, w8, out)
        int8_matmul.launches += 1
        int8_matmul.by_shape[(m, k, n)] += 1
    return out


int8_matmul.launches = 0
int8_matmul.by_shape = Counter()


def bf16_matmul(x, w):
    """K7b: x [M, K] bf16, w [N, K] bf16 -> bf16 [M, N]."""
    _check(x, w, torch.bfloat16, "bf16_matmul")
    if x.device.type == "cpu":
        return bf16_matmul_reference(x, w)
    _check_cuda(x, w, "bf16_matmul")
    m, n = x.shape[0], w.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m and n:
        _launch("unite_bf16_matmul", x, w, out)
        bf16_matmul.launches += 1
    return out


bf16_matmul.launches = 0
