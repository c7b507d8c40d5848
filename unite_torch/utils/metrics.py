"""Host-side training meters and the calibration metric of the eval
protocol (unite_tpu/utils/metrics.py): the reference's MetricLogger and
SmoothedValue (utils.py:215-423) and ``compute_ece``."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np


def _device_peak_mb() -> Optional[float]:
    """Peak bytes allocated on the current CUDA device in MB, the
    reference's log entry (utils.py:338-352); None without a card."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / (1024 * 1024)


class SmoothedValue:
    """Track a series of values; expose window-smoothed and global stats."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    """Windowed meters + periodic progress lines with ETA.

    API-parity with reference utils.py:277-363 (``update``, ``meters``,
    ``log_every``), as unite_tpu/utils/metrics.py has it.
    """

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(f"{type(self).__name__} has no attribute {attr!r}")

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        mem_fmt = _device_peak_mb()  # None on backends without stats (CPU)
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space_fmt = f":{len(str(total))}d" if total else ""
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta = str(datetime.timedelta(seconds=int(eta_seconds)))
                    parts = [
                        header,
                        ("[{0" + space_fmt + "}/{1}]").format(i, total),
                        f"eta: {eta}",
                        str(self),
                        f"time: {iter_time}",
                        f"data: {data_time}",
                    ]
                    if mem_fmt is not None:
                        # the reference appends max_memory_allocated
                        # (utils.py:338-352)
                        mem = _device_peak_mb()
                        if mem is not None:
                            parts.append(f"max mem: {mem:.0f}MB")
                    print(self.delimiter.join(parts))
                else:
                    print(self.delimiter.join([header, f"[{i}]", str(self)]))
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(
            f"{header} Total time: "
            f"{datetime.timedelta(seconds=int(total_time))} "
            f"({total_time / max(i, 1):.4f} s / it)"
        )




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
