"""The UMT pretraining dataset (unite_tpu/data/datasets.py
``VideoMAEPretrainDataset``, the reference's mae.py:38-307 + build.py:32-78):
CSV annotations (path<sep>label), TSN segment sampling, the group transform
stack and the data-side mask.

Output layout is [T, H, W, C]: float32 normalized (the PIL path) or uint8
(``device_normalize``, normalized in the train step). Every item draws from
one Generator per (seed, epoch, index), so items are a pure function of
these: the same as the JAX package's, bitwise-reproducible across resume
and independent of loader workers.
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple

import numpy as np

from unite_torch.data import transforms as T
from unite_torch.data.samplers import pretrain_segment_indices
from unite_torch.data.video_reader import VideoReaderBase, default_reader

if TYPE_CHECKING:
    from PIL import Image

MAX_DECODE_RETRIES = 50


def load_annotations(anno_path: str, sep: str = " ") -> Tuple[List[str], List[int]]:
    """path<sep>label lines (kinetics_sparse.py:85-88)."""
    paths, labels = [], []
    with open(anno_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(sep)
            paths.append(parts[0])
            labels.append(int(parts[-1]))
    return paths, labels


def _subsample(samples: List, labels: List, fraction: float, seed: int):
    """train_fraction subsetting (kinetics_sparse.py:90-95) — seed-derived
    instead of ambient ``random.sample`` so the subset is reproducible."""
    rng = np.random.default_rng([seed, 0xF8AC])
    keep = int(fraction * len(samples))
    idx = rng.permutation(len(samples))[:keep]
    return [samples[i] for i in idx], [labels[i] for i in idx]


def _item_rng(seed: int, epoch: int, index: int, salt: int = 0
              ) -> np.random.Generator:
    """One Generator per (seed, epoch, index[, sample]): host augmentation is
    a pure function of these — bitwise-reproducible across resume and
    independent of loader threading."""
    return np.random.default_rng([seed, epoch, index, salt])


def _to_pil(clip: np.ndarray) -> List["Image.Image"]:
    from PIL import Image

    return [Image.fromarray(f) for f in clip]


def _from_pil(frames: List["Image.Image"]) -> np.ndarray:
    return np.stack([np.asarray(f, np.uint8) for f in frames])


class VideoMAEPretrainDataset:
    """UMT pretrain dataset: group-transform stack + data-side mask
    (mae.py:38-307 + build.py:32-78)."""

    def __init__(
        self,
        anno_path: str,
        mask_gen: Optional[Callable] = None,
        num_segments: int = 8,
        skip_length: int = 8,
        new_step: int = 1,
        input_size: int = 224,
        scales=(1.0, 0.875, 0.75, 0.66),
        color_jitter: float = 0.0,
        flip: bool = False,
        temporal_jitter: bool = False,
        num_sample: int = 1,
        fraction: float = 1.0,
        sep: str = " ",
        reader: Optional[VideoReaderBase] = None,
        seed: Optional[int] = None,
        device_normalize: bool = False,
    ):
        self.device_normalize = device_normalize
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0
        self.samples, self.labels = load_annotations(anno_path, sep)
        if fraction < 1.0:
            self.samples, self.labels = _subsample(
                self.samples, self.labels, fraction, self.seed)
        self.mask_gen = mask_gen
        self.num_segments = num_segments
        self.skip_length = skip_length
        self.new_step = new_step
        self.temporal_jitter = temporal_jitter
        self.num_sample = num_sample
        self.reader = reader or default_reader()

        # build.py:36-54 pipeline: MultiScaleCrop [+ ColorJitter(strength)
        # when color_jitter > 0] [+ flip] — the reference applies NO
        # grayscale stage and passes the CONFIGURED strength through
        # (build.py:38-46, transforms.py:108-116)
        self.crop = T.GroupMultiScaleCrop(input_size, scales)
        self.color_jitter = (T.GroupColorJitter(float(color_jitter))
                             if color_jitter else None)
        self.flip = T.GroupRandomHorizontalFlip(0.5) if flip else None

    def __len__(self):
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _load(self, index: int,
              rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        for _ in range(MAX_DECODE_RETRIES):
            path = self.samples[index]
            try:
                n = self.reader.num_frames(path)
                ids = pretrain_segment_indices(
                    n, self.num_segments, self.skip_length, self.new_step,
                    self.temporal_jitter, rng,
                )
                return self.reader.get_batch(path, ids), self.labels[index]
            except Exception as e:
                warnings.warn(f"pretrain video {path} failed to decode: {e!r}")
                index = int(rng.integers(0, len(self)))
        raise RuntimeError("too many consecutive decode failures")

    def _transform(self, clip: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
        if self.device_normalize and self.color_jitter is None:
            # uint8 path: identical geometry draws (same _sample_crop rng
            # calls), a numpy slice and one bilinear resize of the clip
            # instead of per-frame PIL objects; /255 + mean/std run in the
            # train step on the card
            h, w = clip.shape[1], clip.shape[2]
            crop_w, crop_h, x1, y1 = self.crop._sample_crop((w, h), rng)
            out = clip[:, y1:y1 + crop_h, x1:x1 + crop_w]
            tw, th = self.crop.input_size
            if (crop_w, crop_h) != (tw, th):
                out = T.resize_frames(out, tw, th)
            if self.flip is not None and rng.random() < self.flip.prob:
                out = out[:, :, ::-1]
            return np.ascontiguousarray(out)

        frames = _to_pil(clip)
        frames = self.crop(frames, rng)
        if self.color_jitter is not None:
            frames = self.color_jitter(frames, rng)
        if self.flip is not None:
            frames = self.flip(frames, rng)
        if self.device_normalize:
            return _from_pil(frames)
        return T.stack_normalize(frames).astype(np.float32)

    def __getitem__(self, index: int):
        rng = _item_rng(self.seed, self.epoch, index)
        clip, label = self._load(index, rng)
        if self.num_sample > 1:
            out = []
            for s in range(self.num_sample):
                srng = _item_rng(self.seed, self.epoch, index, salt=s + 1)
                out.append((self._transform(clip, srng),
                            self.mask_gen(srng) if self.mask_gen else -1,
                            label))
            return out
        video = self._transform(clip, rng)
        # attention masking is device-side: emit -1 like build.py:68-69
        mask = self.mask_gen(rng) if self.mask_gen else -1
        return video, mask, label
