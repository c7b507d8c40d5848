"""Low-level clip functionals (unite_tpu/data/functional.py, the
reference's functional_umt.py:32-109): crop_clip, resize_clip,
get_resize_sizes and normalize over numpy clips [T, H, W, C], kept for the
API surface; the pipelines use data/transforms.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from unite_torch.data.transforms import resize_clip as _resize_clip


def crop_clip(clip: np.ndarray, min_h: int, min_w: int, h: int, w: int
              ) -> np.ndarray:
    """Crop [T, H, W, C] at (min_h, min_w) with size (h, w)."""
    return clip[:, min_h : min_h + h, min_w : min_w + w]


def get_resize_sizes(im_h: int, im_w: int, size: int) -> Tuple[int, int]:
    """Short-side resize target (functional_umt.py:87-94)."""
    if im_w < im_h:
        ow = size
        oh = int(size * im_h / im_w)
    else:
        oh = size
        ow = int(size * im_w / im_h)
    return oh, ow


def resize_clip(clip: np.ndarray, size, interpolation: str = "bilinear"
                ) -> np.ndarray:
    return _resize_clip(clip, size, interpolation)


def normalize(clip: np.ndarray, mean, std) -> np.ndarray:
    """(clip - mean) / std, fp32 (functional_umt.py:97-109)."""
    return (clip.astype(np.float32) - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)
