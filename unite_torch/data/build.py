"""Dataset factories (unite_tpu/data/build.py, the reference's
build.py:32-257): ``build_pretraining_dataset`` with its mask-generator
wiring, and ``build_dataset``, the finetune datasets' name dispatch with
its ``nb_classes`` checks. The sparse dataset serves Kinetics_sparse /
mitv1_sparse / UCF101 / HMDB51 (CSV video lists), ``Kinetics`` the dense
one; SSV2 disables horizontal flip (kinetics_sparse.py:258,
build.py:166-199).
"""

from __future__ import annotations

from typing import Optional

from unite_torch.data.datasets import (VideoClsDatasetSparse,
                                      VideoMAEPretrainDataset)
from unite_torch.ops.masking import RandomMaskingGenerator, TubeMaskingGenerator

DATASET_NB_CLASSES = {
    "Kinetics": 400,
    "Kinetics_sparse": 400,
    "SSV2": 174,
    "UCF101": 101,
    "HMDB51": 51,
    "mitv1_sparse": 339,
}


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


def build_dataset(mode: str, args, anno_path: Optional[str] = None,
                  reader=None):
    """build.py:105-257 surface: (dataset, nb_classes). mode in
    train/validation/test."""
    data_set = getattr(args, "data_set", "Kinetics_sparse")
    if data_set not in DATASET_NB_CLASSES and not getattr(args, "nb_classes", 0):
        raise NotImplementedError(f"unknown dataset {data_set}")
    nb_classes = getattr(args, "nb_classes", 0) or DATASET_NB_CLASSES[data_set]
    # the reference's `assert nb_classes == args.nb_classes` (build.py:254):
    # Kinetics-family datasets take their class count FROM args (that is how
    # Daily-DA's 8/12/23-class subsets ride data_set=Kinetics_sparse,
    # build.py:107-150), but the fixed-class datasets must match — a stale
    # --nb_classes would otherwise silently build a wrong-width head
    if (data_set not in ("Kinetics", "Kinetics_sparse", "mitv1_sparse")
            and data_set in DATASET_NB_CLASSES
            and nb_classes != DATASET_NB_CLASSES[data_set]):
        raise ValueError(
            f"nb_classes={nb_classes} != {DATASET_NB_CLASSES[data_set]} for "
            f"{data_set} (reference build.py:254 asserts equality)")

    if anno_path is None:
        anno_path = {
            "train": getattr(args, "train_anno_path", None) or args.data_path,
            "validation": getattr(args, "val_anno_path", None) or args.data_path,
            "test": getattr(args, "test_anno_path", None) or args.data_path,
        }[mode]

    if data_set == "SSV2" and getattr(args, "use_raw_frames", False):
        from unite_torch.data.datasets_extra import SSRawFrameClsDataset as DS

        extra = {"name_pattern": getattr(args, "name_pattern", "img_{:05}.jpg")}
    elif data_set == "SSV2":
        # decord-video variant (ref build.py:165-176: use_decord default;
        # num_segment = num_frames, clip_len = 1)
        from unite_torch.data.datasets_extra import SSVideoClsDataset as DS

        extra = {"num_segment": args.num_frames}
    elif data_set == "Kinetics":  # dense sampling family (kinetics.py)
        from unite_torch.data.datasets_extra import VideoClsDatasetDense as DS

        extra = {"frame_sample_rate": getattr(args, "sampling_rate", 2) or 2}
    else:
        DS = VideoClsDatasetSparse
        # the reference's sparse family ALSO honors --sampling_rate: any
        # value > 0 switches every mode to the fixed-stride "skip
        # strategy" (kinetics_sparse.py:138 frame_sample_rate=args.
        # sampling_rate, :282 'skip_frames <= 0' gate); shipped configs
        # use 0 (TSN sparse)
        extra = {"frame_sample_rate": getattr(args, "sampling_rate", 0) or 0}

    ds = DS(
        anno_path=anno_path,
        sep=getattr(args, "split", " "),
        mode=mode,
        **extra,
        clip_len=args.num_frames,
        crop_size=args.input_size,
        short_side_size=getattr(args, "short_side_size", 256),
        test_num_segment=getattr(args, "test_num_segment", 5),
        test_num_crop=getattr(args, "test_num_crop", 3),
        aa=getattr(args, "aa", "rand-m7-n4-mstd0.5-inc1"),
        train_interpolation=getattr(args, "train_interpolation", "bicubic"),
        reprob=getattr(args, "reprob", 0.25),
        remode=getattr(args, "remode", "pixel"),
        recount=getattr(args, "recount", 1),
        num_sample=getattr(args, "num_sample", 1),
        train_fraction=getattr(args, "train_fraction", 1.0),
        return_aug_for_val=getattr(args, "return_aug_for_val", False),
        no_horizontal_flip=(data_set == "SSV2"),
        reader=reader,
        seed=getattr(args, "seed", None),
        device_normalize=getattr(args, "device_normalize", False),
        # all four dataset families inherit the Sparse val/test item paths
        # (or mirror their skip-resize condition), so the device eval
        # transform contract holds across the dispatch
        device_eval_transforms=getattr(args, "device_eval_transforms", False),
    )
    assert nb_classes > 0, "nb_classes must be resolved (build.py:254)"
    return ds, nb_classes
