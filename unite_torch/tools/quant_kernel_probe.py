"""Time the blocked-matmul kernels on the card: bf16 (K7b) and int8 (K7a).

Counterpart of tools/quant_kernel_probe.py::main: at [38400 x 768 x 3072]
(the teacher MLP's rows, rounded to 512 on the TPU) it times K7b, then K7a,
and prints each one's time in µs and its rate, beside one library call that
computes the same product on the same operands (``torch.matmul`` on cuBLAS
for bf16, ``torch._int_mm`` on cuBLASLt for int8)::

    python -m unite_torch.tools.quant_kernel_probe

It runs on CUDA only and raises without a card. ``int8_matmul`` and
``bf16_matmul`` here keep the tool's [K, N] weight; the timed calls take
the port's [N, K], transposed once beforehand.
"""

from __future__ import annotations

import torch

from unite_torch.ops import matmul as MM
from unite_torch.utils.device import resolve_device

M, K, N = 38400, 768, 3072


def int8_matmul(x8, w8):
    """x8 [M, K] int8, w8 [K, N] int8 -> int32 [M, N] (K7a)."""
    return MM.int8_matmul(x8, w8.t().contiguous())


def bf16_matmul(x, w):
    """x [M, K] bf16, w [K, N] bf16 -> bf16 [M, N] (K7b)."""
    return MM.bf16_matmul(x, w.t().contiguous())


def int_mm_operand(x8, w8_nk):
    """The [K, N] right operand that ``torch._int_mm`` takes for the
    weight w8_nk [N, K]: its transposed view (column-major, cuBLASLt's
    preferred form), else a row-major copy."""
    for wk in (w8_nk.t(), w8_nk.t().contiguous()):
        try:
            torch._int_mm(x8[:32], wk)
            return wk
        except RuntimeError:
            continue
    raise RuntimeError("torch._int_mm takes neither layout of the weight")


def time_us(fn, iters: int = 50) -> float:
    """Best of two runs of ``iters`` calls between CUDA events, after three
    warm-up calls (the tool's ``timeit``), in µs a call."""
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / iters)
    return best


def main(device=None):
    """Print and return the probe's lines."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe times the card's kernels: it runs on "
                           "CUDA only")
    gen = torch.Generator(device=dev).manual_seed(0)
    x8 = torch.randint(-127, 127, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 127, (K, N), generator=gen, device=dev,
                       dtype=torch.int8)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
    w8_nk, w_nk = w8.t().contiguous(), w.t().contiguous()
    w8_lib = int_mm_operand(x8, w8_nk)
    flops = 2 * M * K * N
    lines = []
    for label, fn, unit in (
            ("kernel bf16", lambda: MM.bf16_matmul(x, w_nk), "TF/s"),
            ("torch.matmul bf16", lambda: torch.matmul(x, w), "TF/s"),
            ("kernel int8", lambda: MM.int8_matmul(x8, w8_nk), "TOP/s"),
            ("torch._int_mm int8", lambda: torch._int_mm(x8, w8_lib),
             "TOP/s")):
        us = time_us(fn)
        lines.append(f"{label:<20} [{M}x{K}x{N}]: {us:9.1f} us  "
                     f"{flops / us / 1e6:6.1f} {unit}")
        print(lines[-1], flush=True)
    return lines


if __name__ == "__main__":
    main()
