"""Frame-index sampling of the pretraining dataset
(unite_tpu/data/samplers.py): TSN segment offsets with ``skip_length``-long
sub-clips strided by ``new_step`` and optional temporal jitter
(the reference's mae._sample_train_indices, mae.py:253-307).

Samplers take an explicit ``rng`` (np.random.Generator): determinism is
seed-threaded, never ambient, and the draws equal the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _require_rng(rng):
    """Repo convention: every stochastic op takes an explicit
    PRNG — an ambient default_rng() fallback would be silently
    irreproducible. Deterministic branches never reach this."""
    if rng is None:
        raise ValueError(
            "this sampling branch draws randomly: pass an explicit "
            "np.random.Generator (no ambient RNG by convention)")
    return rng


def pretrain_segment_indices(
    num_video_frames: int,
    num_segments: int,
    skip_length: int,
    new_step: int,
    temporal_jitter: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Segment offsets + strided sub-clip unrolling (mae.py:253-307).

    Returns 0-based frame ids of length num_segments * (skip_length//new_step).
    """
    average_duration = (num_video_frames - skip_length + 1) // num_segments
    if average_duration > 0:
        # always draw (even when average_duration == 1 and the draw is a
        # constant 0): the reference consumes one randint here, and the
        # shared per-item rng stream must advance identically
        rng = _require_rng(rng)
        offsets = np.arange(num_segments) * average_duration
        offsets = offsets + rng.integers(0, average_duration,
                                         size=num_segments)
    elif num_video_frames > max(num_segments, skip_length):
        rng = _require_rng(rng)
        offsets = np.sort(
            rng.integers(0, num_video_frames - skip_length + 1, size=num_segments)
        )
    else:
        offsets = np.zeros((num_segments,), dtype=int)
    offsets = offsets + 1  # reference indexes from 1 (mae.py:272)

    steps = skip_length // new_step
    if temporal_jitter:
        skip_offsets = _require_rng(rng).integers(0, new_step, size=steps)
    else:
        skip_offsets = np.zeros(steps, dtype=int)

    frame_ids = []
    for seg_start in offsets:
        offset = int(seg_start)
        for i, _ in enumerate(range(0, skip_length, new_step)):
            if offset + skip_offsets[i] <= num_video_frames:
                frame_id = offset + skip_offsets[i] - 1
            else:
                frame_id = offset - 1
            frame_ids.append(int(frame_id))
            if offset + new_step < num_video_frames:
                offset += new_step
    return frame_ids
