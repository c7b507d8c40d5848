"""Host-side clip transforms of the pretraining dataset
(unite_tpu/data/transforms.py, the "group" stack of the reference's
transforms.py + build.py:32-54): GroupMultiScaleCrop (13 fixed offsets,
scale pairs with max_distort), optional colour jitter, horizontal flip, and
stack + [0,1] scaling + ImageNet normalization.

Two paths, as in the JAX package: PIL frames (Pillow is imported only
there), and the uint8 ``device_normalize`` path, which crops with numpy and
resizes with ``resize_frames`` (torch bilinear, in place of the JAX
package's ``cv2.resize(INTER_LINEAR)``; within one uint8 level of it).

Every stochastic op takes an explicit ``np.random.Generator`` (``rng``) and
draws exactly what the JAX package's op draws, so a dataset item's crop box
and flip equal the JAX package's for the same (seed, epoch, index).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch

from unite_torch.data.samplers import _require_rng

if TYPE_CHECKING:
    from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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


def resize_frames(frames: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [T, H, W, C] -> [T, height, width, C]: bilinear with half-pixel
    centres and no antialiasing (the sampling of cv2.INTER_LINEAR), computed
    in fp32 and rounded to the nearest uint8."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2)
    y = torch.nn.functional.interpolate(
        x.float(), size=(height, width), mode="bilinear", align_corners=False,
        antialias=False)
    return y.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1
                                                              ).numpy().copy()
