"""Stage-1 CLIP alignment loss (unite_tpu/engines/losses.py), in fp32."""

from __future__ import annotations

import torch


def clip_alignment_loss(x_clip, targets, loss_type: str = "l2",
                        row_weights=None):
    """x_clip, targets [K, B, N_vis, C]. 'l2' = mean of (2 - 2 cos) over
    L2-normed vectors; 'mse', 'l1', 'smooth_l1' are elementwise.

    ``row_weights`` [B] 0/1 restricts the mean to the weighted rows (the
    source/target split of ``clip_loss_data``)."""
    x = x_clip.float()
    t = targets.float()
    if loss_type == "l2":
        per = 2.0 - 2.0 * (x * t).sum(dim=-1)
    elif loss_type == "mse":
        per = (x - t).square()
    elif loss_type == "l1":
        per = (x - t).abs()
    elif loss_type == "smooth_l1":
        d = (x - t).abs()
        per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    else:
        raise NotImplementedError(loss_type)
    if row_weights is None:
        return per.mean()
    w = row_weights.float()
    axes = tuple(i for i in range(per.ndim) if i != 1)
    row_mean = per.mean(dim=axes)  # [B]
    return (row_mean * w).sum() / torch.clamp_min(w.sum(), 1.0)
