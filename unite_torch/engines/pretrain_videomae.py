"""VideoMAE pixel-reconstruction pretraining engine
(unite_tpu/engines/pretrain_videomae.py).

The targets are the un-normalized pixels of the masked patches, re-normalized
per patch (mean and unbiased variance over the patch's pixels of each
channel, ``(x - mean) / (sqrt(var) + 1e-6)``), in fp32 and without a
gradient; the loss is the fp32 MSE against the decoder's predictions. Patch
vectors are ordered (kt, kh, kw, c), as ``layers.PatchEmbed`` and the
decoder's head order them.

The batch is ``{"videos", "vis_idx", "mask_idx"}`` as in JAX; a host mask
(``ops.masking.TubeMaskingGenerator``) gives both index sets by one stable
argsort (``mask_indices``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from unite_torch.models.layers import patchify
from unite_torch.ops.normalize import (IMAGENET_MEAN, IMAGENET_STD,
                                        normalize_videos)
from unite_torch.train.train_state import TrainState, clip_by_global_norm
from unite_torch.utils.device import resolve_device


def mask_indices(mask: np.ndarray):
    """Bool (or 0/1) masks [B, N], True = masked -> (vis_idx [B, N_vis],
    mask_idx [B, N_mask]) int64, each in ascending order: one stable
    argsort puts the visible positions first."""
    mask = np.asarray(mask).astype(bool)
    n_vis = int((~mask[0]).sum())
    order = np.argsort(mask.astype(np.int32), axis=-1, kind="stable")
    return order[:, :n_vis].astype(np.int64), order[:, n_vis:].astype(np.int64)


def masked_pixel_targets(videos, mask_idx, patch_size: int, tubelet_size: int,
                         normalize_target: bool = True):
    """The masked patches' pixel targets [B, N_mask, ts*p*p*C] in fp32 from
    ImageNet-normalized ``videos`` [B, T, H, W, C]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=videos.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=videos.device)
    unnorm = videos.float() * std + mean  # back to [0, 1]
    patches = patchify(unnorm, patch_size, tubelet_size)
    if normalize_target:
        b, n, _ = patches.shape
        x = patches.reshape(b, n, -1, unnorm.shape[-1])  # [B, N, P, C]
        mu = x.mean(dim=-2, keepdim=True)
        var = x.var(dim=-2, keepdim=True, correction=1)
        patches = ((x - mu) / (var.sqrt() + 1e-6)).reshape(b, n, -1)
    return torch.gather(patches, 1, mask_idx[..., None].expand(
        -1, -1, patches.shape[-1]))


def make_videomae_train_step(model: torch.nn.Module, *, patch_size: int = 16,
                             tubelet_size: int = 2,
                             normalize_target: bool = True,
                             clip_grad: Optional[float] = None,
                             device=None) -> Callable:
    """Build ``train_step(state, batch, generator=None) -> metrics``.

    ``state.model`` is ``model``, moved to ``device`` (CUDA when None), and
    ``state`` is updated in place. ``batch["videos"]`` [B, T, H, W, C] is
    uint8 (normalized on the device by ``ops.normalize``) or already
    ImageNet-normalized; ``vis_idx`` [B, N_vis] and ``mask_idx``
    [B, N_mask] index the patches. The model's dropout and drop-path masks
    draw from ``generator``. Metrics are 0-d tensors on the device:
    ``loss`` and the pre-clip ``grad_norm``."""
    dev = resolve_device(device)
    model.to(dev)

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None) -> Dict:
        videos = batch["videos"].to(dev, non_blocking=True)
        if videos.dtype == torch.uint8:
            videos = normalize_videos(videos)
        vis_idx = batch["vis_idx"].to(dev, torch.int64)
        mask_idx = batch["mask_idx"].to(dev, torch.int64)
        with torch.no_grad():
            labels = masked_pixel_targets(videos, mask_idx, patch_size,
                                          tubelet_size, normalize_target)
        net = state.model
        net.train()
        preds = state.net(videos, vis_idx, mask_idx, generator)
        loss = torch.mean(torch.square(preds.float() - labels))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = clip_by_global_norm(net.parameters(), clip_grad)
        state.apply_gradients()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step
