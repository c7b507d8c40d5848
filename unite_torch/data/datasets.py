"""The dataset classes of unite_tpu/data/datasets.py:

* ``VideoClsDatasetSparse`` — the classification dataset of every stage's
  default ``data_set: Kinetics_sparse`` (the reference's
  kinetics_sparse.py:48-357): CSV annotations (path<sep>label), TSN sparse
  sampling, the train augmentation order (rand-augment -> normalize ->
  random-resized crop -> erasing, :218-281), validation resize and centre
  crop, the (chunk, crop) test views with their spatial-start arithmetic
  (:186-208), ``train_fraction`` subsampling (:90-95),
  ``return_aug_for_val`` with the milder rand-m3-n2 policy (:174-182), and
  a bounded retry on a clip that fails to decode (:138-143);
* ``VideoMAEPretrainDataset`` — the UMT pretraining dataset (mae.py:38-307 +
  build.py:32-78): TSN segment sampling, the group transform stack and the
  data-side mask.

Output layout is [T, H, W, C]: float32 normalized, or uint8 where
``device_normalize`` leaves the normalization to the step on the card.
Every item draws from one Generator per (seed, epoch, index), so items are
a pure function of these: the same as the JAX package's, bitwise-
reproducible across resume and independent of loader workers.
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple

import numpy as np

from unite_torch.data import transforms as T
from unite_torch.data.rand_augment import (BICUBIC, BILINEAR,
                                           rand_augment_transform)
from unite_torch.data.random_erasing import RandomErasing
from unite_torch.data.samplers import (
    dense_frame_indices,
    enumerate_test_views,
    pretrain_segment_indices,
    sparse_frame_indices,
)
from unite_torch.data.video_reader import VideoReaderBase, default_reader

if TYPE_CHECKING:
    from PIL import Image

MAX_DECODE_RETRIES = 50
LANCZOS = 1  # PIL.Image.Resampling.LANCZOS


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


class VideoClsDatasetSparse:
    """Sparse-sampling classification dataset (train/validation/test)."""

    def __init__(
        self,
        anno_path: str,
        mode: str = "train",
        clip_len: int = 8,
        crop_size: int = 224,
        short_side_size: int = 256,
        test_num_segment: int = 5,
        test_num_crop: int = 3,
        sep: str = " ",
        aa: str = "rand-m7-n4-mstd0.5-inc1",
        train_interpolation: str = "bicubic",
        reprob: float = 0.25,
        remode: str = "pixel",
        recount: int = 1,
        num_sample: int = 1,
        train_fraction: float = 1.0,
        return_aug_for_val: bool = False,
        no_horizontal_flip: bool = False,
        reader: Optional[VideoReaderBase] = None,
        seed: Optional[int] = None,
        device_normalize: bool = False,
        device_eval_transforms: bool = False,
        keep_aspect_ratio: bool = True,
        new_height: int = 256,
        new_width: int = 340,
        frame_sample_rate: int = 0,
    ):
        assert mode in ("train", "validation", "test")
        self.mode = mode
        self.clip_len = clip_len
        self.crop_size = crop_size
        self.short_side_size = short_side_size
        self.test_num_segment = test_num_segment
        self.test_num_crop = test_num_crop
        self.aa = aa
        self.train_interpolation = train_interpolation
        self.reprob = reprob
        self.remode = remode
        self.recount = recount
        self.num_sample = num_sample
        self.frame_sample_rate = int(frame_sample_rate or 0)
        self.return_aug_for_val = return_aug_for_val
        self.no_horizontal_flip = no_horizontal_flip
        self.reader = reader or default_reader()
        if not keep_aspect_ratio:
            # reference keep_aspect_ratio=False branch: decode at an exact
            # aspect-squashing (new_width, new_height) raster — decord's
            # VideoReader(width=, height=) (kinetics_sparse.py:329-338).
            # Default True (native-res decode) everywhere, as upstream.
            # NOTE: the reference hardcodes keep_aspect_ratio=True at every
            # construction site (build.py:143,180,212,244) — no CLI flag
            # reaches this branch in either framework; it exists for
            # dataset-API parity and is covered by tests only.
            # An exact (w, h) raster supersedes any short_side setting a
            # caller-provided reader carried (decode size is fully
            # determined), so reconstructing without it is intentional.
            from unite_torch.data.video_reader import (
                CV2VideoReader,
                NativeVideoReader,
            )

            if isinstance(self.reader, (NativeVideoReader, CV2VideoReader)):
                self.reader = type(self.reader)(
                    size=(int(new_width), int(new_height)))
            else:
                warnings.warn(
                    f"keep_aspect_ratio=False needs a decode-time-scaling "
                    f"reader (NativeVideoReader/CV2VideoReader); "
                    f"{type(self.reader).__name__} decodes at native "
                    f"raster, so the reference's aspect-squash to "
                    f"({new_width}x{new_height}) will NOT happen")
        self.keep_aspect_ratio = keep_aspect_ratio
        self.new_height, self.new_width = int(new_height), int(new_width)
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0
        # uint8 output mode: keep frames uint8 through crop/flip/erase and
        # normalize on device (ops/normalize.normalize_videos) — 4x fewer
        # H2D bytes. Host-normalized fp32 (the reference pipeline) is the
        # parity default; interpolation then happens pre-quantization.
        self.device_normalize = device_normalize
        # ship RAW decoded uint8 val frames; resize+crop+normalize run fused
        # in the eval step on the card (ops/eval_transforms.py). One-raster
        # contract: every video must decode to the same raster — use a
        # short_side-scaled reader (CV2VideoReader(short_side=...)) or a
        # fixed-resolution source; _val_canvas enforces it with a clear error.
        self.device_eval_transforms = device_eval_transforms
        if device_eval_transforms and mode in ("validation", "test"):
            # raw/cropped frames ship uint8; normalize always on device
            self.device_normalize = True
        self._val_canvas: Optional[tuple] = None

        self.samples, self.labels = load_annotations(anno_path, sep)
        if train_fraction < 1.0 and mode == "train":
            self.samples, self.labels = _subsample(
                self.samples, self.labels, train_fraction, self.seed)

        if mode == "test":
            self.test_items = enumerate_test_views(
                len(self.samples), test_num_segment, test_num_crop)

    def __len__(self):
        if self.mode == "test":
            return len(self.test_items)
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item RNG derivation (loaders call this)."""
        self.epoch = int(epoch)

    # -- decode ------------------------------------------------------------

    def _load_clip(self, path: str, chunk_nb: int,
                   rng: np.random.Generator) -> np.ndarray:
        """TSN-sample clip_len frames (kinetics_sparse.py:314-351)."""
        n = self.reader.num_frames(path)
        if n <= 0:
            raise RuntimeError(f"empty video {path}")
        if self.frame_sample_rate > 0:
            # the reference's "skip strategy": a random fixed-stride
            # window in EVERY mode — the skip_frames gate precedes the
            # clip_idx branch, so even test views ignore chunk_nb
            # (kinetics_sparse.py:282,305-311)
            idx = dense_frame_indices(
                n, self.clip_len, self.frame_sample_rate, rng=rng)
        else:
            nseg = self.test_num_segment if self.mode == "test" else 1
            idx = sparse_frame_indices(
                n, self.clip_len, clip_idx=chunk_nb, test_num_segment=nseg,
                rng=rng,
            )
        return self.reader.get_batch(path, idx)

    def _load_with_retry(self, index: int, chunk_nb: int,
                         rng: np.random.Generator):
        for _ in range(MAX_DECODE_RETRIES):
            if self.mode == "test":
                ck, cp, i = self.test_items[index]
                path, label = self.samples[i], self.labels[i]
                chunk = ck
            else:
                path, label = self.samples[index], self.labels[index]
                chunk = chunk_nb
                cp = None
            try:
                return self._load_clip(path, chunk, rng), path, label, cp, chunk
            except Exception as e:
                warnings.warn(
                    f"video {path} not correctly loaded ({self.mode}): {e!r}")
                index = int(rng.integers(0, len(self)))
        raise RuntimeError("too many consecutive decode failures")

    def _check_canvas(self, buffer: np.ndarray, path: str) -> np.ndarray:
        """device_eval_transforms one-raster guard: every decoded val clip
        must share one raster, so val batches stack."""
        if self._val_canvas is None:
            self._val_canvas = buffer.shape[1:]
        elif buffer.shape[1:] != self._val_canvas:
            raise RuntimeError(
                f"--device_eval_transforms needs a fixed decode raster: "
                f"{path} decoded to {buffer.shape[1:]} but the first video "
                f"gave {self._val_canvas}. Use a short_side-scaled reader "
                f"(CV2VideoReader(short_side=...)) or drop the flag for "
                f"mixed-resolution sources.")
        return buffer

    # -- augmentation ------------------------------------------------------

    def _aug_frame(self, buffer: np.ndarray, rng: np.random.Generator,
                   aa: Optional[str] = None,
                   reprob: Optional[float] = None) -> np.ndarray:
        """Train augmentation, same order as kinetics_sparse.py:218-281."""
        aa = aa if aa is not None else self.aa
        reprob = reprob if reprob is not None else self.reprob
        if aa:
            # fixed interpolation from --train_interpolation (the reference
            # passes it into create_random_augment, kinetics_sparse.py:225 →
            # video_transforms.py:667-668 — default bicubic for EVERY op);
            # 'random' keeps timm's per-op (BILINEAR, BICUBIC) draw
            named = {"bilinear": BILINEAR, "bicubic": BICUBIC,
                     "lanczos": LANCZOS}
            ti = self.train_interpolation
            interp = named.get(ti, (BILINEAR, BICUBIC))
            augment = rand_augment_transform(
                aa,
                {"translate_pct": 0.45,
                 "img_mean": tuple(int(round(m * 255)) for m in T.IMAGENET_MEAN),
                 "interpolation": interp},
            )
            buffer = _from_pil(augment(_to_pil(buffer), rng))
        clip = buffer if self.device_normalize else T.tensor_normalize(buffer)
        clip = T.spatial_sampling(
            clip, spatial_idx=-1, min_scale=256, max_scale=320,
            crop_size=self.crop_size,
            random_horizontal_flip=not self.no_horizontal_flip,
            scale=(0.08, 1.0), aspect_ratio=(0.75, 4 / 3),
            rng=rng,
        )
        if reprob > 0:
            erase = RandomErasing(reprob, mode=self.remode,
                                  max_count=self.recount, cube=True)
            clip = erase(np.ascontiguousarray(clip), rng)
        if self.device_normalize:
            return np.ascontiguousarray(clip).astype(np.uint8)
        return clip.astype(np.float32)

    # -- items -------------------------------------------------------------

    def __getitem__(self, index: int):
        rng = _item_rng(self.seed, self.epoch, index)
        if self.mode == "train":
            buffer, path, label, _, _ = self._load_with_retry(index, -1, rng)
            if self.num_sample > 1:
                # list of per-sample tuples -> default_collate flattens
                # (reference multiple_samples_collate, utils.py:854-898);
                # each repeat gets its own salted rng
                return [(self._aug_frame(
                            buffer, _item_rng(self.seed, self.epoch, index,
                                              salt=s + 1)),
                         label, index, {})
                        for s in range(self.num_sample)]
            return self._aug_frame(buffer, rng), label, index, {}

        if self.mode == "validation":
            buffer, path, label, _, _ = self._load_with_retry(index, 0, rng)
            raw = buffer  # full decoded raster: the aug stream below must
            # see it, not the device-path SxS slice (host-path parity)
            if self.device_eval_transforms:
                s = self.short_side_size
                h, w = buffer.shape[1], buffer.shape[2]
                if min(h, w) == s:
                    # decoder-scaled path: slice the long side down to an
                    # SxS canvas (pure view) with the offset chosen so the
                    # device center-crop composes to EXACTLY the host
                    # protocol's ceil((L-crop)/2) origin; the aspect mix
                    # never reaches the one-raster check
                    c = self.crop_size
                    o1 = -(-(max(h, w) - c) // 2) - -(-(s - c) // 2)
                    o1 = min(max(o1, 0), max(h, w) - s)
                    buffer = (buffer[:, o1:o1 + s] if h >= w
                              else buffer[:, :, o1:o1 + s])
                clip = self._check_canvas(np.ascontiguousarray(buffer), path)
            else:
                clip = T.val_transform(buffer, self.short_side_size,
                                       self.crop_size,
                                       normalize=not self.device_normalize)
                clip = clip.astype(
                    np.uint8 if self.device_normalize else np.float32)
            vid = path.split("/")[-1].split(".")[0]
            if self.return_aug_for_val:
                # milder policy for the stage-3 target stream (:174-182);
                # always from the full raster, never the device-path slice
                aug = self._aug_frame(raw, rng, aa="rand-m3-n2-mstd0.5-inc1",
                                      reprob=0.0)
                return clip, aug, label, vid
            return clip, label, vid

        # test: short-side resize then strided spatial window (:186-208)
        buffer, path, label, split_nb, chunk_nb = self._load_with_retry(
            index, 0, rng)
        if (self.device_eval_transforms
                and min(buffer.shape[1], buffer.shape[2])
                == self.short_side_size):
            # decoder already delivered the short side (CV2VideoReader
            # short_side=) — the crops below are pure uint8 slices, so the
            # whole host test pipeline is decode-only. See
            # ops/eval_transforms.py for why the crop grid stays host-side.
            pass
        else:
            buffer = T.resize_clip(
                buffer if self.device_normalize else buffer.astype(np.float32),
                self.short_side_size)
        h, w = buffer.shape[1], buffer.shape[2]
        long_side = max(h, w)
        if self.test_num_crop == 1:
            start = int((long_side - self.short_side_size) / 2)
        else:
            step = (long_side - self.short_side_size) / (self.test_num_crop - 1)
            start = int(split_nb * step)
        if h >= w:
            buffer = buffer[:, start : start + self.short_side_size, :, :]
        else:
            buffer = buffer[:, :, start : start + self.short_side_size, :]
        vid = path.split("/")[-1].split(".")[0]
        if self.device_normalize:
            clip = np.ascontiguousarray(buffer).astype(np.uint8)
        else:
            clip = T.tensor_normalize(buffer).astype(np.float32)
        return clip, label, vid, chunk_nb, split_nb


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
            # calls), a numpy slice and cv2's bilinear resize instead of
            # per-frame PIL objects; /255 + mean/std run in the train step
            # on the card
            h, w = clip.shape[1], clip.shape[2]
            crop_w, crop_h, x1, y1 = self.crop._sample_crop((w, h), rng)
            out = clip[:, y1:y1 + crop_h, x1:x1 + crop_w]
            tw, th = self.crop.input_size
            if (crop_w, crop_h) != (tw, th):
                out = T.resize_clip(out, (th, tw))
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
