"""Per-step LR / weight-decay tables (unite_tpu/utils/schedules.py): the
cosine and step families, and the linear scaling rule."""

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


def step_scheduler(
    base_value: float,
    step_fraction=None,
    epochs: int = 0,
    niter_per_ep: int = 0,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
    warmup_steps: int = -1,
    steps=None,
) -> np.ndarray:
    """Warmup then constant, with optional multiplicative step drops.

    The reference's utils.py:665-686: each milestone epoch in
    ``steps`` multiplies the tail from ``steps[i]*niter_per_ep`` onward by
    ``step_fraction[i]`` (milestones are absolute training epochs). Two
    latent reference defects fixed here, not replicated: (a) its steps
    branch builds a FULL-length table and still concatenates warmup in
    front, so 'step' + warmup trips its own length assert (utils.py:679-685);
    (b) run_stage2.py:663-667 passes the scalar ``args.step_fraction`` where
    this indexes ``step_fraction[i]`` — a scalar is accepted and broadcast;
    (c) the reference's steps branch never multiplies ``base_value`` into
    its table (utils.py:679-681 builds np.ones and applies fractions only),
    so its step-schedule LR ignores the configured base LR — here
    ``base_value`` applies, so step-schedule values deliberately differ
    from the reference's defective branch ('constant' is identical).
    """
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup_schedule = np.array([])
    # guard on warmup_ITERS, not warmup_epochs: the reference's guard on
    # warmup_epochs makes --warmup_steps with warmup_epochs=0 shorten the
    # decay segment while building an EMPTY warmup, tripping the length
    # assert (utils.py:650-655 latent defect, fixed not replicated)
    if warmup_iters > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)

    schedule = np.ones(epochs * niter_per_ep - warmup_iters) * base_value
    if steps is not None:
        if not hasattr(step_fraction, "__len__"):
            step_fraction = [step_fraction] * len(steps)
        for i in range(len(steps)):
            schedule[max(0, steps[i] * niter_per_ep - warmup_iters):] \
                *= step_fraction[i]

    schedule = np.concatenate((warmup_schedule, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


def scaled_lr(base_lr: float, total_batch_size: int,
              num_sample: int = 1) -> float:
    """Linear LR scaling rule: lr * B_total * num_sample / 256."""
    return base_lr * total_batch_size * num_sample / 256.0
