"""Torch-bicubic square resize as two matmuls (unite_tpu/ops/eval_transforms.py).

Used by the stage-1 step to bring clips to the teacher's resolution; at the
default ``clip_input_resolution`` of 224 the resize is skipped."""

from __future__ import annotations

import numpy as np
import torch


def torch_bicubic_weights(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """[dst, src] separable resize matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)``: half-pixel centers, 4 border-clamped taps, Keys
    cubic with a = -0.75, no antialiasing."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)

    def k(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        f = int(np.floor(center))
        frac = center - f
        for m in (-1, 0, 1, 2):
            w[i, min(max(f + m, 0), src - 1)] += k(m - frac)
    return w.astype(np.float32)


def bicubic_resize_square(videos, out_size: int):
    """[..., H, H, C] -> [..., out, out, C], computed in fp32, returned in
    the input dtype."""
    h = videos.shape[-3]
    if h == out_size:
        return videos
    w = torch.from_numpy(torch_bicubic_weights(h, out_size)).to(videos.device)
    x = videos.float()
    x = torch.einsum("os,...swc->...owc", w, x)
    x = torch.einsum("pw,...owc->...opc", w, x)
    return x.to(videos.dtype)
