"""Eval-time resizes on the card (unite_tpu/ops/eval_transforms.py).

* The torch-bicubic square resize as two matmuls: the stage-1 step brings
  clips to the teacher's resolution with it (at the default
  ``clip_input_resolution`` of 224 the resize is skipped).
* ``--device_eval_transforms``: the host ships the decoded uint8 frames and
  the val protocol (short-side resize, centre crop, /255 and ImageNet
  mean/std; the reference's kinetics_sparse.py:101-108) runs in the eval
  step on the card. The resize is ``F.interpolate(mode="bilinear",
  align_corners=False, antialias=False)``: half-pixel centres with no
  downscale prefilter, the sampling of ``cv2.INTER_LINEAR`` and of the JAX
  package's ``jax.image.resize(..., antialias=False)``. These are plain
  tensor ops; no kernel of the port is behind them.

Every clip of one call must share one raster (the datasets check it); the
test protocol's crop grid stays on the host, where its crops are uint8
slices of the short-side-resized buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from unite_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD


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


def resize_short_side(videos: torch.Tensor, short_side: int) -> torch.Tensor:
    """[..., H, W, 3] -> short side == ``short_side``, aspect kept (the
    long side rounds as ``data/transforms.py::resize_clip``:
    int(size * long / short)), bilinear in fp32. Returns the input when the
    short side already matches."""
    h, w = videos.shape[-3], videos.shape[-2]
    if w < h:
        ow, oh = short_side, int(short_side * h / w)
    else:
        ow, oh = int(short_side * w / h), short_side
    if (oh, ow) == (h, w):
        return videos
    lead, c = videos.shape[:-3], videos.shape[-1]
    x = videos.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    x = torch.nn.functional.interpolate(x, size=(oh, ow), mode="bilinear",
                                        align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).reshape(*lead, oh, ow, c)


def center_crop(videos: torch.Tensor, crop_size: int) -> torch.Tensor:
    """The centre ``crop_size`` square, at the host path's offset
    (transforms.py::uniform_crop index 1: ceil((dim - size) / 2))."""
    h, w = videos.shape[-3], videos.shape[-2]
    y = -(-(h - crop_size) // 2)
    x = -(-(w - crop_size) // 2)
    return videos[..., y:y + crop_size, x:x + crop_size, :]


def device_val_transform(videos: torch.Tensor, short_side: int,
                         crop_size: int, dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [..., H, W, 3] decoded frames -> normalized [..., C, C, 3] in
    ``dtype``: resize the short side, crop the centre, /255, mean/std.
    Float inputs are taken as already normalized and cropped (only cast),
    and a uint8 input already at ``crop_size`` square is only normalized
    (the val/test rasters of --device_eval_transforms arrive with their
    short side at ``short_side``)."""
    if videos.dtype != torch.uint8:
        return videos.to(dtype)
    if videos.shape[-3] == videos.shape[-2] == crop_size:
        x = videos.float()
    else:
        x = center_crop(resize_short_side(videos, short_side).float(),
                        crop_size)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=videos.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=videos.device)
    return ((x / 255.0 - mean) / std).to(dtype)


def make_device_val_transform(short_side: int, crop_size: int,
                              dtype=torch.bfloat16):
    """``batch["videos"] -> model input`` for ``make_eval_step``."""
    def fn(videos):
        return device_val_transform(videos, short_side, crop_size, dtype)
    return fn
