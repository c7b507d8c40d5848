"""Video decode backends (unite_tpu/data/video_reader.py): native, OpenCV
and synthetic.

Training reads indexed frame batches (``get_batch(path, indices)``), uint8
[N, H, W, C] RGB. Backends:

* ``NativeVideoReader`` — ctypes binding to the port's own build of the
  FFmpeg decoder (unite_torch/native/videodec.cpp, built at first use by
  ``unite_torch.native._build``), random access by frame index, with the
  short-side or exact-size resize done in the decode's swscale pass;
* ``CV2VideoReader``   — OpenCV VideoCapture (sequential seek), imported
  only when a video is opened, with an optional resize after decode;
* ``SyntheticVideoReader`` — deterministic procedurally-generated frames
  keyed by (path, index), bitwise the JAX package's, for tests and
  benchmarks without video files.

``default_reader`` takes the native decoder where it builds and loads, else
OpenCV, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
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


class NativeVideoReader(VideoReaderBase):
    """ctypes wrapper over the native FFmpeg decoder (the ``vd_*`` entry
    points of unite_torch/native/videodec.cpp).

    ``short_side``: decode-time bilinear resize of the short side, the long
    side truncated as ``transforms.resize_clip`` truncates it (the swscale
    pass that converts to RGB24 also scales). ``size``: an exact
    (width, height) decode, decord's ``VideoReader(width=, height=)``
    aspect-squashing, the dataset's ``keep_aspect_ratio=False`` branch;
    it takes precedence over ``short_side``."""

    def __init__(self, short_side: Optional[int] = None,
                 size: Optional[tuple] = None):
        self.short_side = short_side
        self.size = size

    @staticmethod
    def load_library():
        """The decoder library, built on first use; raises ImportError
        (with the compiler's output) where it cannot be built or loaded."""
        from unite_torch.native import _build

        try:
            return _build.load()
        except (OSError, RuntimeError) as e:
            raise ImportError(
                f"native video decoder not available: {e}") from e

    @classmethod
    def available(cls) -> bool:
        try:
            cls.load_library()
            return True
        except ImportError:
            return False

    def _open(self, path: str):
        lib = self.load_library()
        if self.size:
            w, h = self.size
            handle = lib.vd_open_sized(path.encode(), int(w), int(h))
        elif self.short_side:
            handle = lib.vd_open_scaled(path.encode(), int(self.short_side))
        else:
            handle = lib.vd_open(path.encode())
        if not handle:
            raise FileNotFoundError(f"cannot open video: {path}")
        return lib, handle

    def _probe_num_frames(self, path: str) -> int:
        lib, h = self._open(path)
        try:
            return int(lib.vd_num_frames(h))
        finally:
            lib.vd_close(h)

    def get_batch(self, path: str, indices: Sequence[int]) -> np.ndarray:
        lib, h = self._open(path)
        try:
            w, hh = int(lib.vd_width(h)), int(lib.vd_height(h))
            idx = np.ascontiguousarray(indices, np.int64)
            out = np.empty((len(idx), hh, w, 3), np.uint8)
            rc = lib.vd_get_batch(
                h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc != 0:
                raise RuntimeError(f"decode failed ({rc}): {path}")
            return out
        finally:
            lib.vd_close(h)


class CV2VideoReader(VideoReaderBase):
    """OpenCV VideoCapture. ``size`` (an exact (width, height)) or
    ``short_side`` resizes each batch after the decode
    (``transforms.resize_clip``, host-side: the capture has no decode-time
    scaling), as the JAX package's reader does; by default frames keep
    their native raster."""

    def __init__(self, short_side: Optional[int] = None,
                 size: Optional[tuple] = None):
        self.short_side = short_side
        self.size = size

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
            from unite_torch.data.transforms import resize_clip

            if self.size:
                w, h = self.size
                out = resize_clip(out, (int(h), int(w)))
            elif self.short_side:
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
    """The native decoder where it builds and loads, else OpenCV's reader
    (``short_side``: the short side of each decoded frame)."""
    if NativeVideoReader.available():
        return NativeVideoReader(short_side=short_side)
    return CV2VideoReader(short_side=short_side)
