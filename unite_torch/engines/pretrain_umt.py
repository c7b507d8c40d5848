"""Stage-1 engine: UMT masked pre-training against the frozen CLIP teacher
(unite_tpu/engines/pretrain_umt.py).

One step: normalize -> resize for the teacher -> teacher forward (no grad)
-> teacher-attention Gumbel top-k mask -> gather and project the teacher's
taps at the visible tokens -> student forward and backward on the visible
tokens -> alignment loss -> global norm (and optional clip) -> AdamW.

``batch["vis_idx"]`` [B, N_vis], when present, bypasses the mask sampler
(data-side masks, or the same masks fed to both packages in parity tests).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from unite_torch.engines.losses import clip_alignment_loss
from unite_torch.models.clip import project_clip_taps
from unite_torch.ops.eval_transforms import bicubic_resize_square
from unite_torch.ops.masking import (
    attention_multinomial_mask,
    frame_mask_to_video,
    n_visible_total,
    visible_indices,
)
from unite_torch.ops.normalize import normalize_videos
from unite_torch.train.train_state import TrainState, clip_by_global_norm
from unite_torch.utils.device import resolve_device


def resize_for_teacher(videos, clip_input_resolution: int):
    """Torch-bicubic resize to the teacher's resolution (skipped when the
    clip already has it)."""
    if videos.shape[-3] == videos.shape[-2] == clip_input_resolution:
        return videos
    return bicubic_resize_square(videos, clip_input_resolution)


def make_pretrain_train_step(
    student: torch.nn.Module,
    teacher: torch.nn.Module,
    *,
    num_patches: int,
    frames: int,
    mask_ratio: float,
    source_batch_size: int,
    mask_type: str = "attention",
    clip_loss_type: str = "l2",
    clip_loss_data: str = "target",
    clip_grad: Optional[float] = None,
    clip_input_resolution: int = 224,
    device=None,
) -> Callable:
    """Build ``train_step(state, batch, generator=None) -> metrics``.

    ``state.model`` is the student; ``state`` is updated in place. Student
    and teacher are moved to ``device`` (CUDA when None); the teacher is
    frozen. ``batch["videos"]`` [B, T, H, W, C] holds the source rows, then
    the target rows; optional ``src_mask`` [B] marks the source rows.
    Metrics are 0-d tensors on the device: ``loss``, ``loss_clip`` and the
    pre-clip ``grad_norm``."""
    dev = resolve_device(device)
    student.to(dev)
    teacher.to(dev).eval().requires_grad_(False)
    if clip_loss_data not in ("mixed", "source", "target"):
        raise NotImplementedError(clip_loss_data)
    patches_per_frame = num_patches // frames
    nv_total = n_visible_total(num_patches, frames, mask_ratio)

    def loss_of(x_clip, targets, batch):
        if clip_loss_data == "mixed":
            return clip_alignment_loss(x_clip, targets, clip_loss_type)
        if "src_mask" in batch:
            w = batch["src_mask"].to(dev, torch.float32)
            if clip_loss_data == "target":
                w = 1.0 - w
            return clip_alignment_loss(x_clip, targets, clip_loss_type,
                                       row_weights=w)
        rows = (slice(None, source_batch_size) if clip_loss_data == "source"
                else slice(source_batch_size, None))
        return clip_alignment_loss(x_clip[:, rows], targets[:, rows],
                                   clip_loss_type)

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None) -> Dict:
        videos = normalize_videos(batch["videos"].to(dev, non_blocking=True))
        b = videos.shape[0]
        with torch.no_grad():
            clip_videos = resize_for_teacher(videos, clip_input_resolution)
            z_raw, attn = teacher(clip_videos, raw_taps=True)
            if attn.shape[-1] != patches_per_frame:
                raise ValueError(
                    f"teacher patch grid ({attn.shape[-1]}/frame) != student "
                    f"grid ({patches_per_frame}/frame); set "
                    f"clip_input_resolution so teacher_res/teacher_patch == "
                    f"student_res/student_patch (196 for L/14 teachers)")
            if z_raw.shape[2] != num_patches:
                raise ValueError(
                    f"teacher token count ({z_raw.shape[2]}) != student "
                    f"patches ({num_patches}): teacher frames x grid must "
                    f"equal the student's num_frames/tubelet_size x grid")
            if "vis_idx" in batch:
                vis_idx = batch["vis_idx"].to(dev, torch.int64)
            elif mask_type == "attention":
                mask_bt = attention_multinomial_mask(attn, mask_ratio,
                                                     generator=generator)
                vis_idx = visible_indices(frame_mask_to_video(mask_bt, b),
                                          nv_total)
            else:
                raise ValueError(
                    f"mask_type {mask_type!r} requires vis_idx in the batch")
            k, _, _, width = z_raw.shape
            raw_vis = torch.gather(
                z_raw, 2, vis_idx[None, :, :, None].expand(k, -1, -1, width))
            targets = project_clip_taps(teacher, raw_vis,
                                        teacher.clip_norm_type, teacher.dtype)

        student = state.model
        student.train()
        # through the step's module (a DDP wrapper's hooks must fire)
        x_clip = state.net(videos, vis_idx, clip_only=True,
                           generator=generator)
        loss = loss_of(x_clip, targets, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = clip_by_global_norm(student.parameters(), clip_grad)
        state.apply_gradients()
        loss = loss.detach()
        return {"loss": loss, "loss_clip": loss, "grad_norm": grad_norm}

    return train_step
