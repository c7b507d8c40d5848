"""Calibration metric of the eval protocol (unite_tpu/utils/metrics.py)."""

from __future__ import annotations

import numpy as np


def compute_ece(probs: np.ndarray, labels: np.ndarray, n_bins: int = 15) -> float:
    """Expected Calibration Error over softmax probabilities, with
    equal-width confidence bins:
    ``ECE = sum_b (|B_b|/N) * |acc(B_b) - conf(B_b)|``."""
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels)
    conf = probs.max(axis=-1)
    pred = probs.argmax(axis=-1)
    correct = (pred == labels).astype(np.float64)
    n = len(labels)
    ece = 0.0
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        cnt = in_bin.sum()
        if cnt > 0:
            ece += (cnt / n) * abs(correct[in_bin].mean() - conf[in_bin].mean())
    return float(ece)
