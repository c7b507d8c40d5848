"""Video decode backends (unite_tpu/data/video_reader.py): OpenCV and
synthetic.

Training reads indexed frame batches (``get_batch(path, indices)``), uint8
[N, H, W, C] RGB. Backends:

* ``CV2VideoReader``   — OpenCV VideoCapture (sequential seek), imported
  only when a video is opened, with an optional short-side resize after
  decode;
* ``SyntheticVideoReader`` — deterministic procedurally-generated frames
  keyed by (path, index), bitwise the JAX package's, for tests and
  benchmarks without video files.

The JAX package's first choice, the native FFmpeg decoder
(unite_tpu/native/videodec.cpp), has no binding here yet (ROADMAP queue 1,
item 6): ``default_reader`` takes OpenCV and, where OpenCV is missing too,
raises naming the binding.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np

class VideoReaderBase:
    # every dataset item calls num_frames(path) then get_batch(path, idx):
    # without a memo that is TWO container opens + stream probes per item
    # per epoch. Frame count
    # is immutable for a training run and independent of decode scaling,
    # so the base class memoizes it per path (bounded; cleared at cap).
    _NFRAMES_CAP = 100_000

    def num_frames(self, path: str) -> int:
        cache = self.__dict__.setdefault("_nframes_cache", {})
        n = cache.get(path)
        if n is None:
            n = self._probe_num_frames(path)
            if len(cache) >= self._NFRAMES_CAP:
                cache.clear()
            cache[path] = n
        return n

    def _probe_num_frames(self, path: str) -> int:
        raise NotImplementedError

    def get_batch(self, path: str, indices: Sequence[int]) -> np.ndarray:
        raise NotImplementedError


class CV2VideoReader(VideoReaderBase):
    """OpenCV VideoCapture. ``short_side`` resizes each batch after the
    decode (``transforms.resize_clip``, host-side: the capture has no
    decode-time scaling), as the JAX package's reader does; by default
    frames keep their native raster."""

    def __init__(self, short_side: Optional[int] = None):
        self.short_side = short_side

    def _probe_num_frames(self, path: str) -> int:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise FileNotFoundError(f"cannot open video: {path}")
            return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()

    def get_batch(self, path: str, indices: Sequence[int]) -> np.ndarray:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise FileNotFoundError(f"cannot open video: {path}")
            frames = {}
            want = sorted(set(int(i) for i in indices))
            pos = 0
            for target in want:
                if target != pos:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, target)
                    pos = target
                ok, frame = cap.read()
                pos += 1
                if not ok:
                    raise RuntimeError(f"decode failed at frame {target}: {path}")
                frames[target] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            out = np.stack([frames[int(i)] for i in indices])
            if self.short_side:
                from unite_torch.data.transforms import resize_clip

                out = resize_clip(out, int(self.short_side))
            return out
        finally:
            cap.release()


class SyntheticVideoReader(VideoReaderBase):
    """Deterministic fake videos: shape/content derived from the path hash."""

    def __init__(self, height: int = 128, width: int = 160,
                 frames: Optional[int] = None):
        self.height = height
        self.width = width
        self.frames = frames

    def _seed(self, path: str) -> int:
        return int(hashlib.md5(path.encode()).hexdigest()[:8], 16)

    def num_frames(self, path: str) -> int:
        if self.frames is not None:
            return self.frames
        return 40 + self._seed(path) % 80

    def get_batch(self, path: str, indices: Sequence[int]) -> np.ndarray:
        # the content formula (yy*base + xx*(255-base) + 7i) mod 256 is
        # separable: precompute per-row and per-column byte patterns, then
        # broadcast-add in uint8 — native wraparound IS the mod 256, so the
        # hot loop is two uint8 adds per element (bitwise-identical to the
        # naive int64 formula)
        seed = self._seed(path)
        idx = np.asarray(list(indices), np.int64)
        base = np.stack([
            np.random.default_rng(seed + int(i)).integers(0, 255, size=3)
            for i in idx
        ])  # [N, 3]
        yy = np.arange(self.height, dtype=np.int64)
        xx = np.arange(self.width, dtype=np.int64)
        row = ((yy[None, :, None] * base[:, None, :]) % 256).astype(np.uint8)
        col = ((xx[None, :, None] * (255 - base)[:, None, :]) % 256).astype(
            np.uint8)
        off = ((idx * 7) % 256).astype(np.uint8)
        out = row[:, :, None, :] + col[:, None, :, :]  # uint8 wrap = mod 256
        out += off[:, None, None, None]
        return out


def default_reader(short_side: Optional[int] = None) -> VideoReaderBase:
    """OpenCV's reader (``short_side``: resize each batch's short side to
    it). The JAX package prefers its native decoder, whose binding the port
    does not have yet."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "no video decoder: the port has no binding for the native "
            "decoder (unite_tpu/native/videodec.cpp, ROADMAP queue 1 item "
            "6) and OpenCV (cv2) is not installed; use --synthetic_data "
            "true or install opencv-python") from e
    return CV2VideoReader(short_side=short_side)
