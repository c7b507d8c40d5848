"""Classify one video file with a trained checkpoint of the port.

Counterpart of tools/classify.py: one clip through the validation path
(the reader, TSN sparse sampling, resize, centre crop and normalize:
kinetics_sparse.py:92-99), the ViT forward in bf16 and the top five
classes with their softmax probabilities::

    python -m unite_torch.tools.classify runs/stage2/exp/checkpoint-best.pth \\
        video.mp4 [--nb-classes 12] [--num-frames 8] \\
        [--model vit_base_patch16_224] [--synthetic] [--cpu]

The checkpoint is one the port's entries write (``.pth``): a stage-2 ViT,
or a stage-3 combined one, whose student encoder and ``classifier`` head
are loaded into the ViT. It runs on the card, or on the CPU with
``--cpu``; ``--synthetic`` reads a synthetic clip instead of the file.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from unite_torch.models.clip_text import CLASS_NAMES
from unite_torch.utils import checkpoint as ck
from unite_torch.utils.device import resolve_device
from unite_torch.utils.registry import create_model
from unite_torch.utils.torch_export import split_combined
from unite_torch.utils.torch_import import merge_state


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ckpt", help="a checkpoint of the port (a stage-2 ViT "
                                 "or a stage-3 combined one)")
    ap.add_argument("video", help="video file path")
    ap.add_argument("--model", default="vit_base_patch16_224")
    ap.add_argument("--nb-classes", type=int, default=12)
    ap.add_argument("--num-frames", type=int, default=8)
    ap.add_argument("--tubelet-size", type=int, default=1)
    ap.add_argument("--input-size", type=int, default=224)
    ap.add_argument("--short-side-size", type=int, default=224)
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic reader (smoke test, ignores the file)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def read_clip(a) -> np.ndarray:
    """The clip as the validation transform gives it: fp32 [1, T, H, W, C]
    from a one-row annotation file."""
    from unite_torch.data.datasets import VideoClsDatasetSparse
    from unite_torch.data.video_reader import (SyntheticVideoReader,
                                               default_reader)

    with tempfile.NamedTemporaryFile("w", suffix=".csv", delete=False) as f:
        f.write(f"{a.video} 0\n")
        ann = f.name
    try:
        ds = VideoClsDatasetSparse(
            anno_path=ann, mode="validation", clip_len=a.num_frames,
            crop_size=a.input_size, short_side_size=a.short_side_size,
            reader=(SyntheticVideoReader() if a.synthetic
                    else default_reader()))
        clip = ds[0][0]  # (clip, label, name, ...) in validation mode
    finally:
        os.unlink(ann)
    return np.asarray(clip, np.float32)[None]


def load_weights(model, path: str) -> None:
    """A stage-2 checkpoint's weights as they are; a stage-3 combined
    one's student encoder, with its ``classifier`` as the ViT's head."""
    state, head = split_combined(ck.load_checkpoint(path)["model"])
    if head is not None:
        encoder = {k[len("encoder."):]: v for k, v in state.items()
                   if k.startswith("encoder.")}
        state = dict(encoder or state,
                     **{f"head.{k}": v for k, v in head.items()})
    merge_state(model, state)


def class_probs(a, device=None) -> np.ndarray:
    """fp32 softmax probabilities [nb_classes] of the clip."""
    dev = resolve_device("cpu" if a.cpu else device)
    video = read_clip(a)
    model = create_model(a.model, device=dev, dtype=torch.bfloat16,
                         num_classes=a.nb_classes, img_size=a.input_size,
                         all_frames=a.num_frames,
                         tubelet_size=a.tubelet_size)
    load_weights(model, a.ckpt)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(video).to(dev, torch.bfloat16))
    return torch.softmax(logits.float(), -1)[0].cpu().numpy()


def top_lines(probs: np.ndarray, k: int = 5) -> list:
    """The ``k`` most probable classes, one printed line each."""
    n = len(probs)
    names = CLASS_NAMES.get(n, [f"class_{i}" for i in range(n)])
    return [f"{probs[i]:6.3f}  {names[i]}" for i in np.argsort(probs)[::-1][:k]]


def main(argv=None, device=None) -> np.ndarray:
    """Print the top five; return all the probabilities. The card unless
    ``--cpu`` or ``device`` says otherwise."""
    probs = class_probs(parser().parse_args(argv), device)
    for line in top_lines(probs):
        print(line)
    return probs


if __name__ == "__main__":
    main()
