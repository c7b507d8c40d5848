"""On-device video normalization (unite_tpu/ops/normalize.py)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_videos(videos, dtype=torch.bfloat16):
    """uint8 [..., H, W, 3] -> (x/255 - mean)/std in ``dtype``; other dtypes
    are taken as already normalized and only cast."""
    if videos.dtype == torch.uint8:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                            device=videos.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                           device=videos.device)
        x = videos.float() / 255.0
        return ((x - mean) / std).to(dtype)
    return videos.to(dtype)
