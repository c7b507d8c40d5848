"""Per-model parameter and FLOP table.

Counterpart of tools/flops.py (the reference's fvcore
``FlopCountAnalysis`` smoke blocks, modeling_finetune.py:439-441): each
model is built on the CPU in fp32 and one forward pass is counted by
``torch.utils.flop_counter.FlopCounterMode`` (``utils.flops.count_flops``),
which counts the matrix products, convolutions and the plain attention
the CPU runs::

    python -m unite_torch.tools.flops                         # main models
    python -m unite_torch.tools.flops vit_base_patch16_224    # one model
    python -m unite_torch.tools.flops --frames 16 --tubelet 2
    python -m unite_torch.tools.flops --batch 8

GFLOPs are per forward pass at the given batch. The JAX tool's "GB moved"
column is XLA's count of the fused program's bytes; eager PyTorch has no
such program, so the port leaves that column out.
"""

from __future__ import annotations

import argparse
import sys

import torch

from unite_torch.utils.flops import count_flops
from unite_torch.utils.registry import create_model

DEFAULT_MODELS = [
    "vit_base_patch16_224",
    "adaptation_umt_base_patch16_224",
    "pretrain_umt_base_patch16_224",
    "clip_b16",
]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("models", nargs="*", default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--tubelet", type=int, default=1)
    ap.add_argument("--input-size", type=int, default=224)
    ap.add_argument("--mask-ratio", type=float, default=0.8,
                    help="stage-1 mask ratio used to size the visible set "
                         "for the masked-gather models")
    return ap


def model_cost(name: str, batch: int, frames: int, tubelet: int,
               input_size: int, mask_ratio: float):
    """Build ``name`` on the CPU with zero weights; return (parameters,
    forward FLOPs)."""
    kwargs = {}
    size = input_size
    if name.startswith("vit_"):
        kwargs.update(all_frames=frames, tubelet_size=tubelet, num_classes=12)
        if input_size != 224:
            kwargs.update(img_size=input_size)
    elif name.startswith("clip_"):
        # the clip factories pin their input resolution (224, or 336 for
        # *_336); --input-size other than 224 overrides it
        native = 336 if name.endswith("_336") else 224
        size = input_size if input_size != 224 else native
        if size != native:
            kwargs.update(input_resolution=size)
    else:
        kwargs.update(num_frames=frames, tubelet_size=tubelet)
        if input_size != 224:
            # these factories pin img_size=224, as the reference's do
            print(f"[flops] {name}: factory pins img_size=224; "
                  f"ignoring --input-size {input_size}", file=sys.stderr)
            size = 224
    # the counts need shapes, not values: built without initializing its
    # weights and tables, then zeroed on the CPU
    model = create_model(name, device="meta", **kwargs).to_empty(
        device="cpu").eval()
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.zero_()
    args = (torch.zeros((batch, frames, size, size, 3)),)
    if name.startswith(("adaptation_", "pretrain_umt")):
        # masked-gather models run on the visible subset; cost them at the
        # stage-1 geometry (mask_ratio of the token grid kept hidden)
        patches = frames // tubelet * (size // 16) ** 2
        n_vis = int(round(patches * (1.0 - mask_ratio)))
        args += (torch.arange(n_vis).repeat(batch, 1),)
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        flops = count_flops(model, *args)
    return n_params, flops or 0.0


def table(a) -> list:
    """The header lines and one row a model."""
    lines = [f"batch={a.batch} frames={a.frames} tubelet={a.tubelet} "
             f"input={a.input_size} mask_ratio={a.mask_ratio}",
             f"{'model':<36} {'params(M)':>10} {'GFLOPs':>10}"]
    print("\n".join(lines), flush=True)
    for name in a.models or DEFAULT_MODELS:
        n_params, flops = model_cost(name, a.batch, a.frames, a.tubelet,
                                     a.input_size, a.mask_ratio)
        lines.append(f"{name:<36} {n_params / 1e6:>10.2f} "
                     f"{flops / 1e9:>10.2f}")
        print(lines[-1], flush=True)
    return lines


def main(argv=None) -> list:
    """Print and return the table. The count is taken on the CPU, where
    the plain attention runs through the dispatcher (the card's kernels
    do not)."""
    return table(parser().parse_args(argv))


if __name__ == "__main__":
    main()
