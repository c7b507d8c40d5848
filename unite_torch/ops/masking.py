"""Token masking for stage 1 (unite_tpu/ops/masking.py).

Mask convention: True = masked, False = visible. The teacher-attention mask
samples N_vis patches per frame without replacement, proportional to the
teacher's CLS attention, by the Gumbel top-k trick.
"""

from __future__ import annotations

from typing import Optional

import torch


def n_visible(num_patches: int, mask_ratio: float) -> int:
    """N_vis = N - int(N * mask_ratio)."""
    return num_patches - int(num_patches * mask_ratio)


def n_visible_total(num_patches: int, frames: int, mask_ratio: float,
                    mask_type: str = "attention") -> int:
    """Whole-video visible count: 'random' masks over the whole video, the
    attention and tube masks per frame (320 of 1568 at ratio 0.8, 8 x 196)."""
    if mask_type == "random":
        return num_patches - int(mask_ratio * num_patches)
    return n_visible(num_patches // frames, mask_ratio) * frames


def visible_indices(mask, n_vis: int):
    """Indices of the visible (False) entries of ``mask`` [..., N] in their
    original order (a stable sort), [..., n_vis] int64."""
    order = torch.argsort(mask.to(torch.int32), dim=-1, stable=True)
    return order[..., :n_vis]


def attention_multinomial_mask(attn, mask_ratio: float, *,
                               generator: Optional[torch.Generator] = None,
                               gumbel=None):
    """attn [BT, N] nonnegative weights -> bool mask [BT, N], True = masked.

    Keys log(max(w, 1e-30)) + Gumbel(0, 1); the top N_vis keys stay visible.
    ``gumbel`` [BT, N] replaces the draw (tests feed both packages the same
    noise); otherwise it comes from ``generator``."""
    bt, n = attn.shape
    nv = n_visible(n, mask_ratio)
    logw = torch.log(torch.clamp_min(attn.float(), 1e-30))
    if gumbel is None:
        u = torch.rand((bt, n), generator=generator, device=attn.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
    keys = logw + gumbel.to(logw.device, torch.float32)
    vis = torch.topk(keys, nv, dim=-1).indices
    mask = torch.ones((bt, n), dtype=torch.bool, device=attn.device)
    return mask.scatter(1, vis, False)


def frame_mask_to_video(mask_bt, batch: int):
    """[B*T, N] per-frame mask -> [B, T*N] per-video mask."""
    return mask_bt.reshape(batch, -1)
