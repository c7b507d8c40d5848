"""Pretraining dataset factory with its mask-generator wiring
(unite_tpu/data/build.py ``build_pretraining_dataset``, the reference's
build.py:32-102). The finetune datasets are not ported yet (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

from typing import Optional

from unite_torch.data.datasets import VideoMAEPretrainDataset
from unite_torch.ops.masking import RandomMaskingGenerator, TubeMaskingGenerator


def make_mask_generator(mask_type: str, window_size, mask_ratio: float):
    """build.py:55-69: tube/random generators; 'attention' masks on device
    (the dataset then emits -1 placeholders)."""
    if mask_type == "tube":
        return TubeMaskingGenerator(window_size, mask_ratio)
    if mask_type == "random":
        return RandomMaskingGenerator(window_size, mask_ratio)
    if mask_type in ("attention", "none"):
        return None
    raise NotImplementedError(f"mask type {mask_type}")


def build_pretraining_dataset(args, anno_path: Optional[str] = None,
                              reader=None):
    """build.py:81-102 surface; args uses the stage-1 config names."""
    window_size = (
        args.num_frames // args.tubelet_size,
        args.input_size // args.patch_size,
        args.input_size // args.patch_size,
    )
    # sparse mode when num_segments != 1 (mae.py:142-146): one frame per
    # segment; dense mode: one window of num_frames * step frames strided by
    # step. The stride is --umt_step, unconditionally (reference build.py:93
    # new_step=args.umt_step; sampling_rate feeds only the finetune
    # datasets, build.py:138,207,239). Sparse mode pins new_step=1: the
    # reference's skip_length=1 override makes any umt_step > 1 yield empty
    # clips there (mae.py:131,142-146).
    step = max(1, getattr(args, "umt_step", 1) or 1)
    if args.num_segments != 1:
        num_segments, skip_length, new_step = args.num_segments, 1, 1
    else:
        num_segments, skip_length, new_step = 1, args.num_frames * step, step
    return VideoMAEPretrainDataset(
        anno_path=anno_path or args.data_path,
        sep=getattr(args, "split", " "),
        mask_gen=make_mask_generator(args.mask_type, window_size, args.mask_ratio),
        num_segments=num_segments,
        skip_length=skip_length,
        new_step=new_step,
        input_size=args.input_size,
        color_jitter=float(getattr(args, "color_jitter", 0) or 0),
        flip=getattr(args, "flip", False),
        num_sample=getattr(args, "num_sample", 1),
        fraction=getattr(args, "fraction", 1.0),
        reader=reader,
        seed=getattr(args, "seed", None),
        device_normalize=getattr(args, "device_normalize", False),
    )
