"""Build and load the port's native video decoder.

``videodec.cpp`` is the JAX package's FFmpeg decoder source, copied byte for
byte: the ``vd_*`` entry points read indexed frames of a video (plain,
short-side scaled or at an exact size, the RGB conversion and the resize in
one swscale pass) and the ``jd_*`` entry points decode JPEG frame folders.
It is compiled with ``g++`` at its first use, with the flags of
unite_tpu/native/build.sh, into ``build/unite_torch_native/`` at the
repository root, named by a hash of the source and the flags: a changed
source builds anew, an unchanged one loads at once. The build needs FFmpeg's
development headers and libraries (libavformat, libavcodec, libavutil,
libswscale).

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "videodec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unite_torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED: Optional[BaseException] = None  # a failed build is not retried


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libunite_videodec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless its library is already built; returns its
    path. Raises with the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native video decoder builds "
                           "only where a C++ compiler is installed")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _declare(lib: ctypes.CDLL) -> None:
    """The C interface's argument and result types (JAX's, in
    unite_tpu/data/video_reader.py and datasets_extra.py)."""
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    ip = ctypes.POINTER(ctypes.c_int)
    signatures = {
        "vd_open": (p, [s]),
        "vd_open_scaled": (p, [s, i]),
        "vd_open_sized": (p, [s, i, i]),
        "vd_num_frames": (i, [p]),
        "vd_width": (i, [p]),
        "vd_height": (i, [p]),
        "vd_get_batch": (i, [p, ctypes.POINTER(ctypes.c_int64), i,
                             ctypes.POINTER(ctypes.c_uint8)]),
        "vd_close": (None, [p]),
        "jd_new": (p, []),
        "jd_free": (None, [p]),
        "jd_dims": (i, [s, ip, ip]),
        "jd_probe_with": (i, [p, s, ip, ip]),
        "jd_emit_with": (i, [p, p, i, i]),
        "jd_decode_with": (i, [p, s, p, i, i]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load() -> ctypes.CDLL:
    """The loaded decoder library, building it first if needed. A build or
    load that failed raises again, without a second attempt."""
    global _LIB, _FAILED
    with _LOCK:
        if _FAILED is not None:
            raise _FAILED
        if _LIB is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                _FAILED = e
                raise
            _declare(lib)
            _LIB = lib
    return _LIB
