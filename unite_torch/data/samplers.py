"""Frame-index samplers (unite_tpu/data/samplers.py), numpy only:

* ``sparse_frame_indices``  — kinetics_sparse._get_seq_frames (:283-312):
  TSN over the whole video; train draws uniformly inside each segment, val
  takes the segment midpoint (clip_idx=0 of 1), test spreads
  ``test_num_segment`` clips per segment;
* ``dense_frame_indices``   — the fixed-stride "skip strategy" window;
* ``dense_segment_indices`` — the dense loader's windows (kinetics.py:281-320);
* ``ssv2_segment_indices`` and ``ssv2_raw_frame_indices`` — the two SSV2
  variants (ssv2.py:580-607, :277-322);
* ``pretrain_segment_indices`` — TSN segment offsets with
  ``skip_length``-long sub-clips strided by ``new_step`` and optional
  temporal jitter (the reference's mae._sample_train_indices,
  mae.py:253-307);
* ``enumerate_test_views`` — the test views' (chunk, crop, sample) order.

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


def sparse_frame_indices(
    video_size: int,
    num_frames: int,
    clip_idx: int = -1,
    test_num_segment: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """TSN sparse sampling. clip_idx=-1 → random (train); else deterministic
    clip ``clip_idx`` out of ``test_num_segment`` (val uses (0, 1))."""
    seg_size = max(0.0, float(video_size - 1) / num_frames)
    max_frame = int(video_size) - 1
    seq = []
    if clip_idx == -1:
        rng = _require_rng(rng)
        for i in range(num_frames):
            start = int(np.round(seg_size * i))
            end = int(np.round(seg_size * (i + 1)))
            # random.randint is inclusive on both ends
            seq.append(min(int(rng.integers(start, end + 1)), max_frame))
    else:
        duration = seg_size / (test_num_segment + 1)
        for i in range(num_frames):
            start = int(np.round(seg_size * i))
            seq.append(min(start + int(duration * (clip_idx + 1)), max_frame))
    return seq


def dense_frame_indices(
    video_size: int,
    num_frames: int,
    skip_frames: int,
    rng: Optional[np.random.Generator] = None,
    start: Optional[int] = None,
) -> List[int]:
    """Fixed-stride window ('skip strategy', kinetics_sparse.py:305-311)."""
    max_frame = int(video_size) - 1
    if start is None:
        hi = max(0, max_frame - num_frames * skip_frames)
        rng = _require_rng(rng)
        start = int(rng.integers(0, hi + 1))
    seq = list(range(start, start + num_frames * skip_frames, skip_frames))
    return [min(i, max_frame) for i in seq]


def dense_segment_indices(
    video_size: int,
    clip_len: int,
    frame_sample_rate: int,
    mode: str,
    chunk_nb: int = 0,
    test_num_segment: int = 5,
    num_segment: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """EXACT port of the dense loader's index arithmetic
    (kinetics.py:281-320 loadvideo_decord):

    * test: evenly-spaced window starts over ``test_num_segment`` chunks,
      stride ``frame_sample_rate``, repeat-padded to ``clip_len``;
    * train: per segment, linspace over a random window
      [end-converted, end), end ~ randint(converted, seg_len);
    * validation: the deterministic end ``(seg_len - converted)//2``
      (replicated faithfully — including its early-clip placement);
    * short videos (seg_len <= converted): linspace(0, seg_len) padded with
      the last frame.
    """
    converted_len = int(clip_len * frame_sample_rate)
    if mode == "test":
        step = (max(1.0 * (video_size - converted_len)
                    / (test_num_segment - 1), 0)
                if test_num_segment > 1 else 0.0)
        start = int(chunk_nb * step)
        bound = min(start + converted_len, video_size)
        idx = list(range(start, bound, frame_sample_rate))
        while len(idx) < clip_len:
            idx.append(idx[-1])
        return idx

    seg_len = video_size // num_segment
    all_index: List[int] = []
    for i in range(num_segment):
        if seg_len <= converted_len:
            n = seg_len // frame_sample_rate
            index = np.linspace(0, seg_len, num=n)
            index = np.concatenate(
                (index, np.ones(clip_len - n) * seg_len))
            index = np.clip(index, 0, seg_len - 1).astype(np.int64)
        else:
            if mode == "validation":
                end_idx = (seg_len - converted_len) // 2
            else:
                rng = _require_rng(rng)
                end_idx = int(rng.integers(converted_len, seg_len))
            str_idx = end_idx - converted_len
            index = np.linspace(str_idx, end_idx, num=clip_len)
            index = np.clip(index, str_idx, end_idx - 1).astype(np.int64)
        all_index.extend((index + i * seg_len).tolist())
    return [int(i) for i in all_index]


def ssv2_segment_indices(
    video_size: int,
    num_segment: int,
    mode: str,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """EXACT port of SSVideoClsDataset.loadvideo_decord's TSN arithmetic
    (ssv2.py:580-607):

    * train: ``arange(T)*avg + randint(avg, size=T)`` per segment (sorted
      random over the video when segments are empty, zeros when too short);
    * validation: segment centers ``int(tick/2 + tick*x)``;
    * test: sorted centers + starts (two interleaved temporal views;
      __getitem__ slices ``[chunk_nb::2]``), repeat-padded.
    """
    if mode == "test":
        tick = video_size / float(num_segment)
        idx = ([int(tick / 2.0 + tick * x) for x in range(num_segment)]
               + [int(tick * x) for x in range(num_segment)])
        return np.sort(np.array(idx)).tolist()
    if mode == "validation":
        tick = video_size / float(num_segment)
        return [int(tick / 2.0 + tick * x) for x in range(num_segment)]
    rng = _require_rng(rng)
    avg = video_size // num_segment
    if avg > 0:
        idx = (np.multiply(list(range(num_segment)), avg)
               + rng.integers(0, avg, size=num_segment))
        return [int(i) for i in idx]
    if video_size > num_segment:
        return np.sort(
            rng.integers(0, video_size, size=num_segment)).tolist()
    return [0] * num_segment


def ssv2_raw_frame_indices(
    total_frames: int,
    num_segment: int,
    mode: str,
    test_num_segment: int = 2,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """EXACT port of SSRawFrameClsDataset.load_frame's index arithmetic
    (ssv2.py:277-322) — DIFFERENT from both the kinetics-sparse TSN math
    and the decord-ssv2 variant:

    * test: the full sorted tick grid over ALL test segments,
      ``int(t_seg * tick / test_num_segment + tick * x)`` (the caller
      slices temporal view ``chunk_nb`` as ``buffer[chunk_nb::
      test_num_segment]``);
    * train: ``arange(T) * avg + randint(avg, size=T)`` with
      ``avg = total // T`` (sorted random when avg == 0 and the video is
      long enough; zero-padded ramp when shorter than T);
    * validation: ``arange(T) * avg + avg // 2`` (deterministic segment
      centers; plain ``range(T)`` / zero-pad fallbacks).
    """
    if mode == "test":
        tick = total_frames / float(num_segment)
        idx: List[int] = []
        for t_seg in range(test_num_segment):
            idx.extend(int(t_seg * tick / test_num_segment + tick * x)
                       for x in range(num_segment))
        return np.sort(np.array(idx)).tolist()
    avg = total_frames // num_segment
    if avg > 0:
        if mode == "validation":
            off = np.full(num_segment, avg // 2, dtype=int)
        else:
            off = _require_rng(rng).integers(0, avg, size=num_segment)
        return [int(i) for i in
                np.multiply(list(range(num_segment)), avg) + off]
    if total_frames > num_segment:
        if mode == "validation":
            return list(range(num_segment))
        return np.sort(_require_rng(rng).integers(
            0, total_frames, size=num_segment)).tolist()
    return [0] * (num_segment - total_frames) + list(range(total_frames))


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


def enumerate_test_views(num_samples: int, test_num_segment: int, test_num_crop: int):
    """Enumerate (chunk, crop, sample) test views in the reference's order
    (kinetics_sparse.py:124-130): for ck: for cp: for idx."""
    views = []
    for ck in range(test_num_segment):
        for cp in range(test_num_crop):
            for idx in range(num_samples):
                views.append((ck, cp, idx))
    return views
