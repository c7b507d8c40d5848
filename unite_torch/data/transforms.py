"""Host-side clip transforms (unite_tpu/data/transforms.py) for both
augmentation stacks:

* the pretrain "group" stack (the reference's transforms.py +
  build.py:32-54): GroupMultiScaleCrop (13 fixed offsets, scale pairs with
  max_distort), optional colour jitter, horizontal flip, and stack + [0,1]
  scaling + ImageNet normalization, on PIL frames; its uint8
  ``device_normalize`` path crops with numpy and resizes with
  ``resize_clip``;
* the finetune stack (video_transforms.py + kinetics_sparse.py:218-281) on
  numpy clips [T, H, W, C]: short-side scale jitter, random / uniform /
  centre crops, horizontal flip, random-resized crops (with the "motion
  shift" variant), normalization, ``spatial_sampling`` and
  ``val_transform``.

Every resize of a numpy clip is ``resize_clip``: ``cv2.resize``
(INTER_LINEAR or INTER_CUBIC), as in the JAX package, so the items of
both stacks equal its own bit for bit.

Pillow and OpenCV are imported where a transform uses them, never when the
module is imported.

Every stochastic op takes an explicit ``np.random.Generator`` (``rng``) and
draws exactly what the JAX package's op draws, so a dataset item's crop box
and flip equal the JAX package's for the same (seed, epoch, index).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

import numpy as np

from unite_torch.data.samplers import _require_rng

if TYPE_CHECKING:
    from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class GroupScale:
    """Resize the short side of every frame (transforms.py:119-133)."""

    def __init__(self, size: int, interpolation=None):
        self.size = size
        self.interpolation = interpolation  # None: PIL's BILINEAR

    def __call__(self, frames: List["Image.Image"]):
        from PIL import Image

        interp = (Image.BILINEAR if self.interpolation is None
                  else self.interpolation)
        w, h = frames[0].size
        if (w <= h and w == self.size) or (h <= w and h == self.size):
            return frames
        if w < h:
            ow, oh = self.size, int(self.size * h / w)
        else:
            ow, oh = int(self.size * w / h), self.size
        return [f.resize((ow, oh), interp) for f in frames]


class GroupRandomCrop:
    """One random crop window shared by every frame (transforms.py:31-56)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, frames: List["Image.Image"],
                 rng: Optional[np.random.Generator] = None):
        rng = _require_rng(rng)
        w, h = frames[0].size
        if w < self.size or h < self.size:
            raise ValueError(
                f"frame {w}x{h} smaller than crop size {self.size}")
        if w == self.size and h == self.size:
            return frames
        x1 = int(rng.integers(0, w - self.size + 1))
        y1 = int(rng.integers(0, h - self.size + 1))
        return [f.crop((x1, y1, x1 + self.size, y1 + self.size))
                for f in frames]


class GroupCenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, frames: List["Image.Image"]):
        w, h = frames[0].size
        x1 = int(round((w - self.size) / 2.0))
        y1 = int(round((h - self.size) / 2.0))
        return [f.crop((x1, y1, x1 + self.size, y1 + self.size)) for f in frames]


class GroupRandomHorizontalFlip:
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, frames: List["Image.Image"],
                 rng: Optional[np.random.Generator] = None):
        if _require_rng(rng).random() < self.prob:
            from PIL import Image

            return [f.transpose(Image.FLIP_LEFT_RIGHT) for f in frames]
        return frames


class GroupColorJitter:
    """The reference's GroupColorJitter (transforms.py:108-116): a
    torchvision ColorJitter(brightness=s, contrast=s, saturation=s) —
    NO hue — applied per frame, so factors AND op order redraw for every
    frame (torchvision draws uniform(max(0, 1-s), 1+s) per factor and a
    random op permutation per call)."""

    def __init__(self, size: float = 0.4):
        self.size = float(size)

    def _jitter_one(self, img, rng: np.random.Generator):
        from PIL import ImageEnhance

        s = self.size
        ops = [
            lambda im, f: ImageEnhance.Brightness(im).enhance(f),
            lambda im, f: ImageEnhance.Contrast(im).enhance(f),
            lambda im, f: ImageEnhance.Color(im).enhance(f),  # saturation
        ]
        for i in rng.permutation(3):
            f = rng.uniform(max(0.0, 1.0 - s), 1.0 + s)
            img = ops[int(i)](img, f)
        return img

    def __call__(self, frames: List["Image.Image"],
                 rng: Optional[np.random.Generator] = None):
        rng = _require_rng(rng)
        return [self._jitter_one(f, rng) for f in frames]


class GroupMultiScaleCrop:
    """Scale-pair crop with 13 fixed offsets (transforms.py:136-206).

    Picks (crop_w, crop_h) from scale pairs of the short side filtered by
    ``max_distort``, one of 5(+8 more_fix_crop) fixed offsets, crops every
    frame identically, then resizes to ``input_size``.
    """

    def __init__(self, input_size: int, scales=(1.0, 0.875, 0.75, 0.66),
                 max_distort: int = 1, fix_crop: bool = True,
                 more_fix_crop: bool = True):
        self.scales = scales
        self.max_distort = max_distort
        self.fix_crop = fix_crop
        self.more_fix_crop = more_fix_crop
        self.input_size = (input_size, input_size) \
            if isinstance(input_size, int) else input_size

    def __call__(self, frames: List["Image.Image"],
                 rng: Optional[np.random.Generator] = None):
        from PIL import Image

        im_size = frames[0].size
        crop_w, crop_h, x1, y1 = self._sample_crop(im_size, rng)
        crops = [f.crop((x1, y1, x1 + crop_w, y1 + crop_h)) for f in frames]
        return [c.resize(self.input_size, Image.BILINEAR) for c in crops]

    def _sample_crop(self, im_size, rng: Optional[np.random.Generator] = None):
        rng = _require_rng(rng)
        w, h = im_size
        base = min(w, h)
        crop_sizes = [int(base * s) for s in self.scales]
        # snap to input size when within 3px (reference :166-168)
        crop_h_opts = [self.input_size[1] if abs(c - self.input_size[1]) < 3
                       else c for c in crop_sizes]
        crop_w_opts = [self.input_size[0] if abs(c - self.input_size[0]) < 3
                       else c for c in crop_sizes]
        pairs = []
        for i, ch in enumerate(crop_h_opts):
            for j, cw in enumerate(crop_w_opts):
                if abs(i - j) <= self.max_distort:
                    pairs.append((cw, ch))
        crop_w, crop_h = pairs[int(rng.integers(len(pairs)))]
        if not self.fix_crop:
            x1 = int(rng.integers(0, w - crop_w + 1))
            y1 = int(rng.integers(0, h - crop_h + 1))
        else:
            offsets = self._fill_fix_offset(w, h, crop_w, crop_h)
            x1, y1 = offsets[int(rng.integers(len(offsets)))]
        return crop_w, crop_h, x1, y1

    def _fill_fix_offset(self, image_w, image_h, crop_w, crop_h):
        w_step = (image_w - crop_w) // 4
        h_step = (image_h - crop_h) // 4
        offsets = [
            (0, 0), (4 * w_step, 0), (0, 4 * h_step), (4 * w_step, 4 * h_step),
            (2 * w_step, 2 * h_step),
        ]
        if self.more_fix_crop:
            offsets += [
                (0, 2 * h_step), (4 * w_step, 2 * h_step),
                (2 * w_step, 4 * h_step), (2 * w_step, 0 * h_step),
                (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step),
            ]
        return offsets


def stack_normalize(frames: List["Image.Image"],
                    mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """PIL list → [T, H, W, C] fp32, /255, ImageNet-normalized
    (Stack + ToTorchFormatTensor + GroupNormalize, build.py:48-53)."""
    arr = np.stack([np.asarray(f, np.float32) for f in frames]) / 255.0
    return (arr - mean) / std


# ---------------------------------------------------------------------------
# Tensor clip ops (finetune path): numpy [T, H, W, C]
# ---------------------------------------------------------------------------


def resize_clip(clip: np.ndarray, size, interpolation="bilinear") -> np.ndarray:
    """Resize each frame. size: int (short side) or (h, w)."""
    import cv2

    t, h, w, c = clip.shape
    if isinstance(size, int):
        if w < h:
            ow, oh = size, int(size * h / w)
        else:
            ow, oh = int(size * w / h), size
    else:
        oh, ow = size
    interp = cv2.INTER_LINEAR if interpolation == "bilinear" else cv2.INTER_CUBIC
    return np.stack([cv2.resize(f, (ow, oh), interpolation=interp) for f in clip])


def random_short_side_scale_jitter(clip: np.ndarray, min_size: int,
                                   max_size: int,
                                   rng: Optional[np.random.Generator] = None
                                   ) -> np.ndarray:
    """video_transforms.py:63-103: uniform short-side in [min, max]."""
    rng = _require_rng(rng)
    size = int(round(rng.uniform(min_size, max_size)))
    return resize_clip(clip, size)


def random_crop(clip: np.ndarray, size: int,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = _require_rng(rng)
    t, h, w, c = clip.shape
    y = int(rng.integers(0, h - size + 1))
    x = int(rng.integers(0, w - size + 1))
    return clip[:, y : y + size, x : x + size]


def uniform_crop(clip: np.ndarray, size: int, spatial_idx: int) -> np.ndarray:
    """3-crop enumeration (video_transforms.py:210-257): 0=left/top,
    1=center, 2=right/bottom along the longer side."""
    t, h, w, c = clip.shape
    y = int(np.ceil((h - size) / 2))
    x = int(np.ceil((w - size) / 2))
    if h > w:
        y = 0 if spatial_idx == 0 else (h - size if spatial_idx == 2 else y)
    else:
        x = 0 if spatial_idx == 0 else (w - size if spatial_idx == 2 else x)
    return clip[:, y : y + size, x : x + size]


def horizontal_flip(clip: np.ndarray, prob: float = 0.5,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = _require_rng(rng)
    if rng.random() < prob:
        return clip[:, :, ::-1]
    return clip


def center_crop(clip: np.ndarray, size: int) -> np.ndarray:
    return uniform_crop(clip, size, 1)


def tensor_normalize(clip: np.ndarray, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD) -> np.ndarray:
    """uint8/float [T,H,W,C] → /255 → (x-mean)/std (kinetics_sparse.py:434).

    The /255 rescale keys on DTYPE exactly like the reference
    (kinetics_sparse.py:442 ``tensor.dtype == torch.uint8``) — a value
    heuristic (max() > 1) would silently mis-normalize an all-dark uint8
    clip (every pixel 0/1: black intro frames, H.264 black level) by
    skipping the rescale."""
    is_uint8 = clip.dtype == np.uint8
    clip = clip.astype(np.float32)
    if is_uint8:
        clip = clip / 255.0
    return (clip - mean) / std


def random_resized_crop(clip: np.ndarray, target_h: int, target_w: int,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """torchvision-style RRC with one box for all frames
    (video_transforms.py:560-610): 10 tries of area/log-ratio sampling,
    center-crop fallback."""
    import math

    rng = _require_rng(rng)
    t, h, w, c = clip.shape
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y = int(rng.integers(0, h - ch + 1))
            x = int(rng.integers(0, w - cw + 1))
            crop = clip[:, y : y + ch, x : x + cw]
            return resize_clip(crop, (target_h, target_w))
    # fallback: center crop at clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    y = (h - ch) // 2
    x = (w - cw) // 2
    return resize_clip(clip[:, y : y + ch, x : x + cw], (target_h, target_w))


def random_resized_crop_with_shift(
        clip: np.ndarray, target_h: int, target_w: int,
        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """RRC whose box drifts linearly across the clip ("motion shift",
    video_transforms.py:595-639): one box drawn for the first frame, an
    independent one for the last, intermediate frames crop at linearly
    interpolated coordinates, each resized to the target."""
    import math

    rng = _require_rng(rng)
    t, h, w, c = clip.shape

    def draw_box():
        area = h * w
        for _ in range(10):
            target_area = area * rng.uniform(*scale)
            aspect = math.exp(
                rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                y = int(rng.integers(0, h - ch + 1))
                x = int(rng.integers(0, w - cw + 1))
                return y, x, ch, cw
        ch = cw = min(h, w)
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    y0, x0, h0, w0 = draw_box()
    y1, x1, h1, w1 = draw_box()
    ys = np.linspace(y0, y1, t).astype(int)
    xs = np.linspace(x0, x1, t).astype(int)
    hs = np.linspace(h0, h1, t).astype(int)
    ws = np.linspace(w0, w1, t).astype(int)
    frames = [
        resize_clip(clip[i : i + 1, ys[i] : ys[i] + hs[i],
                         xs[i] : xs[i] + ws[i]], (target_h, target_w))[0]
        for i in range(t)
    ]
    return np.stack(frames)


def spatial_sampling(clip: np.ndarray, spatial_idx: int = -1,
                     min_scale: int = 256, max_scale: int = 320,
                     crop_size: int = 224, random_horizontal_flip: bool = True,
                     scale=None, aspect_ratio=None, motion_shift: bool = False,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """kinetics_sparse.py:360-433 dispatch: -1 with scale/ratio → RRC (the
    train path, :246-264; per-frame drifting box when ``motion_shift``,
    kinetics.py:381-397), -1 without → short-side jitter + random crop;
    0/1/2 → deterministic test crop at min_scale."""
    if spatial_idx == -1:
        if scale is None and aspect_ratio is None:
            clip = random_short_side_scale_jitter(clip, min_scale, max_scale, rng)
            clip = random_crop(clip, crop_size, rng)
        else:
            rrc = (random_resized_crop_with_shift if motion_shift
                   else random_resized_crop)
            clip = rrc(
                clip, crop_size, crop_size, scale or (0.08, 1.0),
                aspect_ratio or (3 / 4, 4 / 3), rng,
            )
        if random_horizontal_flip:
            clip = horizontal_flip(clip, 0.5, rng)
        return clip
    assert spatial_idx in (0, 1, 2)
    clip = resize_clip(clip, min_scale)
    return uniform_crop(clip, crop_size, spatial_idx)


def val_transform(clip: np.ndarray, short_side_size: int,
                  crop_size: int, normalize: bool = True) -> np.ndarray:
    """Resize(short side) + CenterCrop + Normalize (kinetics_sparse.py:101-108).

    ``normalize=False`` keeps the uint8 representation for device-side
    normalization."""
    clip = resize_clip(clip, short_side_size)
    clip = center_crop(clip, crop_size)
    return tensor_normalize(clip) if normalize else clip
