"""Time the attention kernels of one checkout on the card, so that two
commits can be compared in turns within one call.

    python3 unite_torch/tools/attention_ab.py TREE
    python3 unite_torch/tools/attention_ab.py TREE --fp32

TREE is the root of a checkout: this one, or another unpacked with
``git archive`` into a directory that .gitignore lists (``build/``). The
script imports TREE's ``chip_smoke.py`` and ``unite_torch`` (run it as a
file, one process per tree, so that no other checkout's package is
loaded), builds TREE's kernels, runs its ``check_kernels`` and
``check_packed_kernels`` at every head-dim-64 shape the smoke takes them
(the main path's, ViT-L/14's, the stage-2 and stage-3 entries', the
masked teacher's and VideoMAE's), ``check_grouped_kernels`` and
``check_flash_kernels``, and prints one line ``AB {json}``: the card's
name and power limit and every device ms those checks measured
(launches queued back to back, ``device_ms``).

With ``--fp32`` it times TREE's fp32 kernels instead (csrc/attn_fp32.cu,
through the wrappers ``fp32_attn_fwd``, ``fp32_attn_dq`` and
``fp32_attn_dkv``) at every shape of TREE's ``FP32_SHAPES``, on views of a
packed qkv as the smoke's ``check_fp32_kernels`` takes them, with TREE's
``device_ms``, beside SDPA's fp32 forward and backward on the same inputs,
and each fp32 entry also from a CUDA graph of 30 launches (``graph_ms``):
at the short shapes the wrappers' host time paces back-to-back launches,
and the graph shows the kernels' own time. Compare two trees in turns,
A / B / B / A, on one card. It raises without a card.
"""

from __future__ import annotations

import importlib
import json
import sys
from functools import partial
from pathlib import Path


def graph_ms(torch, fn, iters: int = 30, replays: int = 5) -> float:
    """Mean device time of one ``fn()`` from a CUDA graph of ``iters``
    calls, replayed ``replays`` times: no host time between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (iters * replays)


def fp32_times(torch, smoke, A) -> dict:
    """Device ms of the fp32 forward (with lse2), dQ and dK/dV (also from a
    CUDA graph) and of SDPA's fp32 forward and backward at each shape of
    ``FP32_SHAPES``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(91)
    times = {}
    for label, b, h, s, d in smoke.FP32_SHAPES:
        scale = d ** -0.5
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
        q, k, v = A._split_heads(qkv, h)
        g = torch.randn((b, h, s, d), generator=gen, device="cuda")
        o, lse = A.fp32_attn_fwd(q, k, v, scale, with_lse=True)
        delta = torch.empty((b, h, s), device="cuda")
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        qc, kc, vc = (x.detach().contiguous().requires_grad_(True)
                      for x in (q, k, v))
        sdpa = partial(F.scaled_dot_product_attention, qc, kc, vc,
                       scale=scale)
        runs = {
            "fp32_fwd": lambda: A.fp32_attn_fwd(q, k, v, scale, True),
            "fp32_dq": lambda: A.fp32_attn_dq(q, k, v, o, g, lse, dq, delta,
                                              scale),
            "fp32_dkv": lambda: A.fp32_attn_dkv(q, k, v, g, lse, delta, dk,
                                                dv, scale),
            "sdpa_fp32_fwd": sdpa,
            "sdpa_fp32_bwd": partial(torch.autograd.grad, sdpa(),
                                     (qc, kc, vc), g, retain_graph=True)}
        for name, run in runs.items():
            times[f"{name}/{label}:device_ms"] = smoke.device_ms(run)
            if name.startswith("fp32"):
                times[f"{name}/{label}:graph_ms"] = graph_ms(torch, run)
        del qkv, q, k, v, g, o, lse, qc, kc, vc, runs
        torch.cuda.empty_cache()
    return times


def main(argv) -> None:
    tree = Path(argv[0]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    smoke = importlib.import_module("chip_smoke")
    A = importlib.import_module("unite_torch.ops.attention")
    build = importlib.import_module("unite_torch.ops._build")
    if not Path(A.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{A.__file__} is not under {tree}: run this "
                           "file with python3, not with -m")
    if not torch.cuda.is_available():
        raise RuntimeError("attention_ab times the kernels on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    if argv[1:] == ["--fp32"]:
        smoke.tf32_off(torch, "attention_ab --fp32")
        print("AB " + json.dumps({"tree": str(tree), "card": smoke.card_line(),
                                  "device_ms": fp32_times(torch, smoke, A)}),
              flush=True)
        return
    s = smoke
    checks = [
        s.check_kernels, s.check_packed_kernels,
        partial(s.check_kernels, heads=16, batches=(s.L14_M // 197, s.L14_B),
                tag="/l14"),
        partial(s.check_packed_kernels, shapes=(("train", 7, True),),
                tag="/b7"),
        partial(s.check_kernels, batches=(5 * 8, 5), tag="/s3"),
        partial(s.check_packed_kernels, shapes=(("train", 5, True),),
                tag="/b5"),
        partial(s.check_kernels, batches=(8 * 64, 32),
                lengths=(41, s.MAE_VISIBLE), tag="/masked"),
        partial(s.check_packed_kernels, shapes=(("train", 32, True),),
                tag="/h6", heads=s.MAE_HEADS),
        s.check_grouped_kernels, s.check_flash_kernels]
    times = {}
    for check in checks:
        for key, res in check(torch, A).items():
            times.update({f"{key}:{f}": v for f, v in res.items()
                          if f.endswith("device_ms")
                          and not f.startswith("library")})
    print("AB " + json.dumps({"tree": str(tree), "card": smoke.card_line(),
                              "device_ms": times}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
