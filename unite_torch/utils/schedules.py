"""Per-step LR / weight-decay tables (unite_tpu/utils/schedules.py)."""

from __future__ import annotations

import math

import numpy as np


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0,
                     warmup_steps: int = -1) -> np.ndarray:
    """Linear warmup then cosine decay, one value per optimizer step."""
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup_schedule = np.array([])
    if warmup_iters > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value,
                                      warmup_iters)
    n_decay = epochs * niter_per_ep - warmup_iters
    schedule = np.array([
        final_value + 0.5 * (base_value - final_value)
        * (1 + math.cos(math.pi * i / n_decay))
        for i in np.arange(n_decay)])
    schedule = np.concatenate((warmup_schedule, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


def scaled_lr(base_lr: float, total_batch_size: int,
              num_sample: int = 1) -> float:
    """Linear LR scaling rule: lr * B_total * num_sample / 256."""
    return base_lr * total_batch_size * num_sample / 256.0
