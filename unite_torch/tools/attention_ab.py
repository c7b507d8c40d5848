"""Time the head-dim-64 attention kernels of one checkout on the card, so
that two commits can be compared in turns within one call.

    python3 unite_torch/tools/attention_ab.py TREE

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
(launches queued back to back, ``device_ms``). Compare two trees in
turns, A / B / B / A, on one card. It raises without a card.
"""

from __future__ import annotations

import importlib
import json
import sys
from functools import partial
from pathlib import Path


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
