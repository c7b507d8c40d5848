"""Token masking for stages 1 and 3 (unite_tpu/ops/masking.py).

Mask convention: True = masked, False = visible. The teacher-attention mask
samples N_vis patches per frame without replacement, proportional to the
teacher's CLS attention, by the Gumbel top-k trick; the stage-3 committee
deals the attention-sorted patches out to k members in turn. The tube and
random masks are drawn on the host by the data path (numpy, the same draws
as the JAX package's generators).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def greedy_committee_masks(attn, mask_ratio: float, k: int):
    """k disjoint high-attention visible sets for the stage-3 committee:
    attn [BT, N] -> bool [k, BT, N], True = masked. Member i unmasks the
    patches at positions i, i + k, i + 2k, ... of the descending attention
    order, the first N_vis of them. The sort is stable, as jnp.argsort is,
    so tied weights keep index order and membership matches JAX's."""
    bt, n = attn.shape
    nv = n_visible(n, mask_ratio)
    order = torch.argsort(-attn, dim=-1, stable=True)
    masks = torch.ones((k, bt, n), dtype=torch.bool, device=attn.device)
    for i in range(k):
        masks[i].scatter_(1, order[:, i::k][:, :nv], False)
    return masks


def frame_mask_to_video(mask_bt, batch: int):
    """[B*T, N] per-frame mask -> [B, T*N] per-video mask."""
    return mask_bt.reshape(batch, -1)


# ---------------------------------------------------------------------------
# Host-side generators (data pipeline; parity with masking_generator.py)
# ---------------------------------------------------------------------------


class TubeMaskingGenerator:
    """Same random per-frame mask tiled across frames (masking_generator.py:24-45)."""

    def __init__(self, input_size, mask_ratio):
        self.frames, self.height, self.width = input_size
        self.num_patches_per_frame = self.height * self.width
        self.num_masks_per_frame = int(mask_ratio * self.num_patches_per_frame)
        self.total_patches = self.frames * self.num_patches_per_frame
        self.total_masks = self.frames * self.num_masks_per_frame

    def __repr__(self):
        return "Tube masking: total {}, mask {}".format(
            self.total_patches, self.total_masks
        )

    def __call__(self, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        # uniform random subset: patch i masked iff its permuted rank falls
        # in the first num_masks slots
        per_frame = (
            rng.permutation(self.num_patches_per_frame)
            < self.num_masks_per_frame
        ).astype(np.float64)
        return np.tile(per_frame, (self.frames, 1)).flatten()


class RandomMaskingGenerator:
    """IID mask over all T*H*W patches (masking_generator.py:48-69)."""

    def __init__(self, input_size, mask_ratio):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 3
        self.frames, self.height, self.width = input_size
        self.num_patches = self.frames * self.height * self.width
        self.num_mask = int(mask_ratio * self.num_patches)

    def __repr__(self):
        return "Random masking: total {}, mask {}".format(
            self.num_patches, self.num_mask
        )

    def __call__(self, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        return (rng.permutation(self.num_patches) < self.num_mask).astype(
            np.float64)
