"""Losses of the stages (unite_tpu/engines/losses.py), all in fp32: the
stage-2 criteria (soft-target CE under mixup, else CE with optional label
smoothing), top-k accuracy, and the stage-1 CLIP alignment loss."""

from __future__ import annotations

import torch


def cross_entropy(logits, labels, label_smoothing: float = 0.0,
                  reduction: str = "mean"):
    """CE over int labels with optional smoothing (torch semantics);
    ``reduction`` is "mean", "sum" or anything else for per-sample."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        loss = ((1.0 - label_smoothing) * nll
                + label_smoothing * -logp.mean(dim=-1))
    else:
        loss = nll
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def soft_target_cross_entropy(logits, soft_targets):
    """timm SoftTargetCrossEntropy: batch mean of -sum(t * logp)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-soft_targets.float() * logp).sum(dim=-1).mean()


def accuracy_topk(logits, labels, ks=(1, 5)):
    """Top-k accuracies in percent, as 0-d tensors on the logits' device;
    k is clamped to the class count."""
    ks = [min(k, logits.shape[-1]) for k in ks]
    pred = logits.float().topk(max(ks), dim=-1).indices
    correct = pred == labels.long()[:, None]
    return [100.0 * correct[:, :k].any(dim=1).float().mean() for k in ks]


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
