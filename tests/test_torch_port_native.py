"""unite_torch's native video decoder binding against unite_tpu's, on the
CPU.

The port builds its own library from unite_torch/native/videodec.cpp (the
JAX package's source with one fault fixed) with g++ into
build/unite_torch_native/, and loads nothing of unite_tpu/native. On clips
written here with OpenCV (mp4v) and JPEG frame folders:

* ``NativeVideoReader`` (``vd_*``): plain, short-side scaled and sized
  decodes bit-equal to JAX's reader (and the plain decode to OpenCV's),
  frame counts equal, random, repeated and backward indices, JAX's errors
  for a missing file and its clamp past the last frame;
* the fault: JAX's unscaled decode of a width that is not a multiple of 16
  (OpenCV's 340x256 clips among them) gives wrong last columns, different
  on every call, and can corrupt the heap; the port's decode is the same
  on every call and equals OpenCV's;
* ``RawFrameReader(use_native=True)`` (``jd_*``): bit-equal to JAX's, the
  probe/emit path equal to the decode path, JAX's errors, and the native
  decode taken where OpenCV is missing;
* ``VideoClsDatasetSparse(keep_aspect_ratio=False)``: the sized decode,
  items bit-equal to JAX's;
* ``default_reader`` takes the native decoder, else OpenCV; a build error
  raises with the compiler's output.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest

from unite_tpu.data import datasets as jds
from unite_tpu.data import datasets_extra as jdx
from unite_tpu.data import video_reader as jreader
from unite_torch.data import datasets as tds
from unite_torch.data import datasets_extra as tdx
from unite_torch.data import video_reader as treader
from unite_torch.native import _build

ROOT = Path(__file__).resolve().parents[1]


def _write_clip(path: str, w: int, h: int, n: int = 60) -> str:
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        f = np.stack([(xx * 3 + i * 4) % 256, (yy * 5 + i) % 256,
                      np.full_like(xx, (i * 9) % 256)], -1).astype(np.uint8)
        f[5:15, 5:25] = 200
        vw.write(f)
    vw.release()
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two mp4v clips of 60 frames: a moving pattern at 64x48 and a
    portrait clip at 48x64."""
    d = tmp_path_factory.mktemp("clips")
    return [_write_clip(str(d / f"{name}.mp4"), w, h)
            for name, (w, h) in (("land", (64, 48)), ("port", (48, 64)))]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A JPEG frame folder of 6 smooth frames (img_00001.jpg ...)."""
    import cv2

    d = tmp_path_factory.mktemp("frames")
    yy, xx = np.mgrid[0:48, 0:64]
    for i in range(1, 7):
        img = np.stack([yy * 2 + xx + 10 * i, xx + 20 * i,
                        yy * 3 + 5 * i], -1).astype(np.uint8)
        img[10:20, 10:30] = (255, 0, 0)
        cv2.imwrite(str(d / f"img_{i:05}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(d)


def _code(path: Path, cut: str) -> list:
    """The source's code lines (comments dropped) without the function
    ``cut``."""
    text = path.read_text()
    i = text.index(cut)
    j = text.index("\n}\n", i)
    return [ln for ln in (text[:i] + text[j:]).splitlines()
            if ln.strip() and not ln.strip().startswith("//")]


def test_the_library_is_the_ports_own_build():
    # the JAX package's source, but for the fix in frame_to_rgb and its
    # scratch frame
    port = _code(ROOT / "unite_torch" / "native" / "videodec.cpp",
                 "void frame_to_rgb")
    ref = _code(ROOT / "unite_tpu" / "native" / "videodec.cpp",
                "void frame_to_rgb")
    assert [ln for ln in port if "std::vector<uint8_t> rgb;" not in ln] == ref
    lib = treader.NativeVideoReader.load_library()
    path = Path(lib._name)
    assert path == _build.library_path() and path.exists()
    assert path.parent == ROOT / "build" / "unite_torch_native"
    maps = Path("/proc/self/maps").read_text()
    assert str(path) in maps
    # the JAX package's library may be loaded by its own tests in this
    # process; the port's handle is not it
    assert "unite_tpu" not in str(path)


INDICES = ([0, 7, 7, 59, 3, 30, 1], list(range(0, 60, 10)),
           list(range(50, -1, -10)), [59, 58, 0])


@pytest.mark.parametrize("kw", [{}, dict(short_side=32), dict(short_side=20),
                                dict(size=(40, 24)), dict(size=(30, 30))])
def test_video_decode_is_bit_equal_to_jax(clips, kw):
    port, ref = treader.NativeVideoReader(**kw), jreader.NativeVideoReader(
        **kw)
    for path in clips:
        assert port.num_frames(path) == ref.num_frames(path) == 60
        for idx in INDICES:
            got, want = port.get_batch(path, idx), ref.get_batch(path, idx)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        if "size" in kw:
            assert got.shape[1:3] == (kw["size"][1], kw["size"][0])


def test_plain_decode_equals_opencv(clips):
    for path in clips:
        idx = [0, 7, 7, 59, 3]
        np.testing.assert_array_equal(
            treader.NativeVideoReader().get_batch(path, idx),
            treader.CV2VideoReader().get_batch(path, idx))


@pytest.mark.parametrize("w,h", [(340, 256), (100, 64), (36, 52)])
def test_unaligned_widths_decode_right_where_jax_does_not(tmp_path, w, h):
    path = _write_clip(str(tmp_path / "odd.mp4"), w, h, n=12)
    idx = [0, 7, 7, 11, 3]
    port = treader.NativeVideoReader()
    first = port.get_batch(path, idx)
    np.testing.assert_array_equal(port.get_batch(path, idx), first)
    np.testing.assert_array_equal(
        first, treader.CV2VideoReader().get_batch(path, idx))
    # the scaled and sized decodes take swscale's scaler, right in both
    for kw in (dict(short_side=32), dict(size=(w // 3, h // 3))):
        np.testing.assert_array_equal(
            treader.NativeVideoReader(**kw).get_batch(path, idx),
            jreader.NativeVideoReader(**kw).get_batch(path, idx))


def test_video_errors_are_jaxs(clips, tmp_path):
    for reader in (treader.NativeVideoReader(), jreader.NativeVideoReader()):
        with pytest.raises(FileNotFoundError):
            reader.get_batch(str(tmp_path / "missing.mp4"), [0])
        with pytest.raises(FileNotFoundError):
            reader.num_frames(str(tmp_path / "missing.mp4"))
        # decord's grace: past the last frame the last decoded one again
        out = reader.get_batch(clips[0], [59, 200])
        np.testing.assert_array_equal(out[0], out[1])
        with pytest.raises(RuntimeError, match="decode failed"):
            reader.get_batch(clips[0], [-1])
    np.testing.assert_array_equal(
        treader.NativeVideoReader().get_batch(clips[0], [3, 500]),
        jreader.NativeVideoReader().get_batch(clips[0], [3, 500]))


@pytest.mark.parametrize("idx", [[0, 2, 3], [0, 1, 2, 0], [5, 4, 0, 5]])
def test_jpeg_decode_is_bit_equal_to_jax(frames, idx):
    port, ref = tdx.RawFrameReader(use_native=True), \
        jdx.RawFrameReader(use_native=True)
    assert port._lib is not None and ref._lib is not None
    got, want = port.get_batch(frames, idx), ref.get_batch(frames, idx)
    assert got.shape == (len(idx), 48, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the probe/emit path (frame 0 decoded once) equals the decode path
    for i, j in enumerate(idx):
        if j == idx[0]:
            np.testing.assert_array_equal(got[i], got[0])
    assert port.num_frames(frames) == ref.num_frames(frames) == 6


def test_jpeg_errors_are_jaxs(frames, tmp_path, monkeypatch):
    for cls in (tdx.RawFrameReader, jdx.RawFrameReader):
        native = cls(use_native=True)
        with pytest.raises(RuntimeError, match="missing frame"):
            native.get_batch(frames, [40])
        with pytest.raises(RuntimeError, match="missing frame"):
            native.get_batch(frames, [0, 40])
        with pytest.raises(RuntimeError, match="JPEG frames only"):
            cls(name_pattern="img_{:05}.png", use_native=True).get_batch(
                frames, [0])
        with pytest.raises(FileNotFoundError):
            native.num_frames(str(tmp_path / "none"))
    # without OpenCV the reader decodes natively, as JAX's does
    ref = tdx.RawFrameReader().get_batch(frames, [1, 3])
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = tdx.RawFrameReader()
    assert reader._lib is not None
    np.testing.assert_array_equal(
        reader.get_batch(frames, [1, 3]),
        jdx.RawFrameReader(use_native=True).get_batch(frames, [1, 3]))
    # the two backends reconstruct chroma edges differently: close, not equal
    diff = np.abs(reader.get_batch(frames, [1, 3]).astype(int) - ref)
    assert diff.mean() < 2.0


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_keep_aspect_ratio_false_decodes_at_the_size_as_jax(clips, tmp_path,
                                                            mode):
    anno = tmp_path / "a.csv"
    anno.write_text("".join(f"{p} {i}\n" for i, p in enumerate(clips)))
    kw = dict(anno_path=str(anno), mode=mode, clip_len=4, crop_size=16,
              short_side_size=20, test_num_segment=2, test_num_crop=2,
              seed=3, keep_aspect_ratio=False, new_width=40, new_height=24)
    port = tds.VideoClsDatasetSparse(reader=treader.NativeVideoReader(), **kw)
    ref = jds.VideoClsDatasetSparse(reader=jreader.NativeVideoReader(), **kw)
    assert port.reader.size == (40, 24)
    assert port.reader.get_batch(clips[1], [0]).shape == (1, 24, 40, 3)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            for a, b in zip(got, want):
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b
    # the OpenCV reader takes the size after its decode, as JAX's does
    cv = tds.VideoClsDatasetSparse(reader=treader.CV2VideoReader(), **kw)
    assert isinstance(cv.reader, treader.CV2VideoReader)
    assert cv.reader.size == (40, 24)


def test_default_reader_takes_the_native_decoder(monkeypatch):
    reader = treader.default_reader(short_side=24)
    assert isinstance(reader, treader.NativeVideoReader)
    assert reader.short_side == 24
    monkeypatch.setattr(treader.NativeVideoReader, "available",
                        classmethod(lambda cls: False))
    reader = treader.default_reader(short_side=24)
    assert isinstance(reader, treader.CV2VideoReader)
    assert reader.short_side == 24


def test_a_build_error_raises_with_the_compilers_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "videodec.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(_build, "SOURCE", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        _build.build()
    assert not list((tmp_path / "out").glob("*.so"))
    assert isinstance(_build.load(), ctypes.CDLL)  # the loaded one stays
