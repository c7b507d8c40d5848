"""Additional dataset families (unite_tpu/data/datasets_extra.py): dense
sampling classification and the two SSV2 variants.

Counterparts of the reference's kinetics.py:46-330 (``VideoClsDataset``,
dense ``frame_sample_rate`` sampling with the (chunk, crop) test grid) and
ssv2.py:46-617 (``SSRawFrameClsDataset``, frame folders named
``img_%05d.jpg`` whose annotation lines carry a frame count, and
``SSVideoClsDataset`` over videos). Augmentation stacks are shared with
data/datasets.py (kinetics.py's _aug_frame matches kinetics_sparse.py's).

Frame folders decode with OpenCV, or with the native library's ``jd_*``
JPEG decoder where OpenCV is missing or the caller asks for it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from unite_torch.data import transforms as T
from unite_torch.data.datasets import VideoClsDatasetSparse, _item_rng
from unite_torch.data.samplers import (
    dense_segment_indices,
    enumerate_test_views,
    ssv2_raw_frame_indices,
    ssv2_segment_indices,
)
from unite_torch.data.video_reader import VideoReaderBase


class VideoClsDatasetDense(VideoClsDatasetSparse):
    """Dense fixed-stride sampling (kinetics.py VideoClsDataset): clip_len
    frames at frame_sample_rate; index arithmetic is the exact port in
    samplers.dense_segment_indices (kinetics.py:281-320)."""

    def __init__(self, *args, frame_sample_rate: int = 2, **kwargs):
        # set AFTER super().__init__: the Sparse base now also accepts a
        # frame_sample_rate (its skip-strategy knob, default 0) and would
        # otherwise overwrite the dense stride with 0
        super().__init__(*args, **kwargs)
        self.frame_sample_rate = frame_sample_rate

    def _load_clip(self, path: str, chunk_nb: int,
                   rng: np.random.Generator) -> np.ndarray:
        n = self.reader.num_frames(path)
        if n <= 0:
            raise RuntimeError(f"empty video {path}")
        idx = dense_segment_indices(
            n, self.clip_len, self.frame_sample_rate,
            mode=self.mode, chunk_nb=max(chunk_nb, 0),
            test_num_segment=self.test_num_segment, rng=rng,
        )
        return self.reader.get_batch(path, idx)


class RawFrameReader(VideoReaderBase):
    """Reads pre-extracted frame folders (ssv2.py filename_tmpl).

    JPEG backends, as in the JAX package: OpenCV (libjpeg-turbo) by
    default, and the native library's ``jd_*`` decoder (libavcodec MJPEG
    and swscale, unite_torch/native/videodec.cpp) where OpenCV is missing
    or ``use_native=True`` asks for it. A forced native reader never falls
    back: the two backends reconstruct 4:2:0 chroma differently at sharp
    chroma edges, so a silent substitute would return other pixels."""

    def __init__(self, name_pattern: str = "img_{:05}.jpg", offset: int = 1,
                 use_native: bool = False):
        from unite_torch.data.video_reader import NativeVideoReader

        self.name_pattern = name_pattern
        self.offset = offset  # frame files index from 1
        self._force_native = use_native
        try:
            import cv2  # noqa: F401

            self._have_cv2 = True
        except ImportError:
            self._have_cv2 = False
        self._lib = None
        if (use_native or not self._have_cv2) \
                and NativeVideoReader.available():
            self._lib = NativeVideoReader.load_library()

    def num_frames(self, path: str) -> int:
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        return len([f for f in os.listdir(path) if f.endswith((".jpg", ".png"))])

    def _frame_path(self, path: str, i) -> str:
        return os.path.join(path, self.name_pattern.format(int(i) + self.offset))

    def get_batch(self, path: str, indices) -> np.ndarray:
        paths = [self._frame_path(path, i) for i in indices]
        if self._force_native and self._lib is None:
            raise RuntimeError(
                "use_native=True but the native decoder library could not "
                "be built or loaded (unite_torch/native/videodec.cpp needs "
                "g++ and FFmpeg's development files)")
        if self._force_native and paths and not paths[0].endswith(".jpg"):
            raise RuntimeError(
                "use_native=True supports JPEG frames only "
                f"(got {os.path.basename(paths[0])})")
        if self._lib is not None and paths and paths[0].endswith(".jpg"):
            out = self._native_batch(paths)
            if out is not None:
                return out
            if self._force_native or not self._have_cv2:
                # no substitute where the native backend was asked for, and
                # none without cv2: the native failure (a bad frame, sizes
                # changing mid-folder) surfaces
                raise RuntimeError(
                    f"native JPEG decode failed for a frame in {path}"
                    + ("" if self._have_cv2 else
                       " and cv2 is unavailable for fallback"))
        import cv2

        frames = []
        for fp in paths:
            img = cv2.imread(fp)
            if img is None:
                raise RuntimeError(f"missing frame {fp}")
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        return np.stack(frames)

    def _native_batch(self, paths):
        """The frames through one decoder handle (codec and swscale contexts
        reused; one handle a call keeps the loader's threads apart): frame
        0 decoded once to learn the size and emitted from the handle, the
        rest decoded into the batch. None where a frame cannot be decoded
        at that size (the caller decides on a fallback); a missing file
        raises."""
        lib = self._lib
        w, h = ctypes.c_int(), ctypes.c_int()
        ctx = lib.jd_new()
        if not ctx:
            return None
        try:
            if lib.jd_probe_with(ctx, paths[0].encode(), ctypes.byref(w),
                                 ctypes.byref(h)) != 0:
                if not os.path.exists(paths[0]):
                    raise RuntimeError(f"missing frame {paths[0]}")
                return None
            out = np.empty((len(paths), h.value, w.value, 3), np.uint8)
            if lib.jd_emit_with(ctx, out[0].ctypes.data_as(ctypes.c_void_p),
                                w.value, h.value) != 0:
                return None
            for i in range(1, len(paths)):
                if lib.jd_decode_with(
                        ctx, paths[i].encode(),
                        out[i].ctypes.data_as(ctypes.c_void_p),
                        w.value, h.value) != 0:
                    if not os.path.exists(paths[i]):
                        raise RuntimeError(f"missing frame {paths[i]}")
                    return None
            return out
        finally:
            lib.jd_free(ctx)


class SSRawFrameClsDataset(VideoClsDatasetSparse):
    """Something-Something raw-frame dataset (ssv2.py:46-341): annotation
    lines are ``dir<sep>num_frames<sep>label`` (frame count explicit, so no
    directory listing per sample); horizontal flip disabled (ssv2 temporal
    semantics, kinetics_sparse.py:258).

    Index arithmetic is the raw-frame port (samplers.ssv2_raw_frame_
    indices — average_duration offsets for train/val, the tick grid for
    test), NOT kinetics TSN; the test item slices temporal view
    ``buffer[chunk_nb::test_num_segment]`` out of the full sorted grid and
    takes the strided spatial window (ssv2.py:179-210)."""

    def __init__(self, anno_path: str, sep: str = " ",
                 name_pattern: str = "img_{:05}.jpg", **kwargs):
        kwargs.setdefault("no_horizontal_flip", True)
        if kwargs.get("reader") is None:
            kwargs["reader"] = RawFrameReader(name_pattern)
        super().__init__(anno_path, sep=sep, **kwargs)
        # re-parse for the optional middle frame-count column
        self._frame_counts = {}
        with open(anno_path) as f:
            for line in f:
                parts = line.strip().split(sep)
                if len(parts) >= 3:
                    self._frame_counts[parts[0]] = int(parts[1])

    def _total_frames(self, path: str) -> int:
        count = self._frame_counts.get(path, -1)
        if count <= 0:
            count = self.reader.num_frames(path)
        return count

    def _load_clip(self, path: str, chunk_nb: int,
                   rng: np.random.Generator) -> np.ndarray:
        idx = ssv2_raw_frame_indices(
            self._total_frames(path), self.clip_len, self.mode,
            test_num_segment=self.test_num_segment, rng=rng)
        return self.reader.get_batch(path, idx)

    def __getitem__(self, index: int):
        if self.mode != "test":
            return super().__getitem__(index)
        # raw-frame test protocol (ssv2.py:179-210): decode the FULL
        # sorted tick grid, temporal view = [chunk_nb::test_num_segment],
        # then the strided spatial window along the long side
        rng = _item_rng(self.seed, self.epoch, index)
        buffer, path, label, split_nb, chunk_nb = self._load_with_retry(
            index, 0, rng)
        if (self.device_eval_transforms
                and min(buffer.shape[1], buffer.shape[2])
                == self.short_side_size):
            pass  # decoder already delivered the short side
        else:
            buffer = T.resize_clip(
                buffer if self.device_normalize else buffer.astype(np.float32),
                self.short_side_size)
        buffer = buffer[chunk_nb::self.test_num_segment]
        h, w = buffer.shape[1], buffer.shape[2]
        long_side = max(h, w)
        if self.test_num_crop == 1:
            start = int((long_side - self.short_side_size) / 2)
        else:
            step = ((long_side - self.short_side_size)
                    / (self.test_num_crop - 1))
            start = int(split_nb * step)
        if h >= w:
            buffer = buffer[:, start:start + self.short_side_size, :, :]
        else:
            buffer = buffer[:, :, start:start + self.short_side_size, :]
        vid = path.split("/")[-1].split(".")[0]
        if self.device_normalize:
            clip = np.ascontiguousarray(buffer).astype(np.uint8)
        else:
            clip = T.tensor_normalize(buffer).astype(np.float32)
        return clip, label, vid, chunk_nb, split_nb


class SSVideoClsDataset(VideoClsDatasetSparse):
    """Something-Something decord-video dataset (ssv2.py:342-617).

    Built with ``num_segment = num_frames`` and ``clip_len = 1`` in the
    reference factory (build.py:170-185); index arithmetic is the exact port
    in samplers.ssv2_segment_indices. Test protocol: the decode returns two
    interleaved temporal views (segment centers + segment starts, sorted);
    view ``chunk_nb`` is ``buffer[chunk_nb::2]`` after the short-side resize
    (ssv2.py:468-486), then the strided spatial window. Horizontal flip is
    disabled (ssv2 temporal semantics)."""

    def __init__(self, anno_path: str, num_segment: int = 8, **kwargs):
        kwargs.setdefault("no_horizontal_flip", True)
        kwargs.setdefault("test_num_segment", 2)
        super().__init__(anno_path, **kwargs)
        self.num_segment = num_segment
        if self.mode == "test":
            # two temporal views regardless of the sparse default
            self.test_items = enumerate_test_views(
                len(self.samples), min(self.test_num_segment, 2),
                self.test_num_crop)

    def _load_clip(self, path: str, chunk_nb: int,
                   rng: np.random.Generator) -> np.ndarray:
        n = self.reader.num_frames(path)
        if n <= 0:
            raise RuntimeError(f"empty video {path}")
        idx = ssv2_segment_indices(n, self.num_segment, self.mode, rng)
        return self.reader.get_batch(path, idx)

    def __getitem__(self, index: int):
        if self.mode != "test":
            return super().__getitem__(index)
        rng = _item_rng(self.seed, self.epoch, index)
        buffer, path, label, split_nb, chunk_nb = self._load_with_retry(
            index, 0, rng)
        if (self.device_eval_transforms
                and min(buffer.shape[1], buffer.shape[2])
                == self.short_side_size):
            pass  # decoder already delivered the short side (see datasets.py)
        else:
            buffer = T.resize_clip(
                buffer if self.device_normalize else buffer.astype(np.float32),
                self.short_side_size)
        buffer = buffer[chunk_nb::2]  # temporal view (ssv2.py:475-481)
        h, w = buffer.shape[1], buffer.shape[2]
        long_side = max(h, w)
        if self.test_num_crop == 1:
            start = int((long_side - self.short_side_size) / 2)
        else:
            step = ((long_side - self.short_side_size)
                    / (self.test_num_crop - 1))
            start = int(split_nb * step)
        if h >= w:
            buffer = buffer[:, start:start + self.short_side_size, :, :]
        else:
            buffer = buffer[:, :, start:start + self.short_side_size, :]
        vid = path.split("/")[-1].split(".")[0]
        if self.device_normalize:
            clip = np.ascontiguousarray(buffer).astype(np.uint8)
        else:
            clip = T.tensor_normalize(buffer).astype(np.float32)
        return clip, label, vid, chunk_nb, split_nb
