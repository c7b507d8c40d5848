"""Random erasing over video clips (unite_tpu/data/random_erasing.py, the
reference's random_erasing.py:47-193): erases
a random rectangle (same cube across all frames when ``cube=True``) with
per-pixel gaussian noise ('pixel'), per-channel noise ('rand'), or a
constant ('const'), in *normalized* space (applied after tensor_normalize,
kinetics_sparse.py:272-281), or on uint8 clips in pixel space when they
are normalized on the card. Count/area/aspect semantics preserved.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from unite_torch.data.samplers import _require_rng
from unite_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


class RandomErasing:
    def __init__(self, probability: float = 0.25, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 max_aspect: Optional[float] = None, mode: str = "pixel",
                 min_count: int = 1, max_count: Optional[int] = None,
                 num_splits: int = 0, cube: bool = True):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        self.num_splits = num_splits
        self.cube = cube
        mode = mode.lower()
        self.rand_color = mode == "rand"
        self.per_pixel = mode == "pixel"
        assert mode in ("rand", "pixel", "const")

    def _fill(self, shape, rng: np.random.Generator, uint8: bool = False):
        if self.per_pixel:
            fill = rng.standard_normal(shape).astype(np.float32)
        elif self.rand_color:
            fill = rng.standard_normal(
                (1,) * (len(shape) - 1) + (shape[-1],)
            ).astype(np.float32)
        else:
            fill = np.zeros(shape, np.float32)
        if uint8:
            # uint8 input path (device-side normalization): map the
            # normalized-space noise N(0,1) into pixel space so the erased
            # region normalizes back to ~N(0,1) on device
            fill = (fill * IMAGENET_STD + IMAGENET_MEAN) * 255.0
            return np.clip(np.round(fill), 0, 255).astype(np.uint8)
        return fill

    def _erase_cube(self, clip: np.ndarray, rng: np.random.Generator):
        t, h, w, c = clip.shape
        uint8 = clip.dtype == np.uint8
        area = h * w
        count = (self.min_count if self.min_count == self.max_count
                 else int(rng.integers(self.min_count, self.max_count + 1)))
        for _ in range(count):
            # 100 placement attempts like the reference (_erase_cube,
            # random_erasing.py:148) — 10 would quietly lower the
            # effective erase rate for extreme area/aspect draws
            for _attempt in range(100):
                target_area = rng.uniform(
                    self.min_area, self.max_area
                ) * area / count
                aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
                eh = int(round(math.sqrt(target_area * aspect)))
                ew = int(round(math.sqrt(target_area / aspect)))
                if ew < w and eh < h:
                    top = int(rng.integers(0, h - eh + 1))
                    left = int(rng.integers(0, w - ew + 1))
                    # the reference's cube mode shares the BOX across
                    # frames but calls _get_pixels per frame
                    # (random_erasing.py:159-168): pixel-mode noise
                    # flickers temporally. cube=False additionally
                    # redraws — identical here; kept for API compat.
                    for ti in range(t):
                        clip[ti, top : top + eh, left : left + ew] = (
                            self._fill((eh, ew, c), rng, uint8)
                        )
                    break
        return clip

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """clip: float32 [T, H, W, C] normalized; modified copy returned."""
        rng = _require_rng(rng)
        if rng.random() >= self.probability:
            return clip
        return self._erase_cube(clip.copy(), rng)
