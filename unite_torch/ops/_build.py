"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Libraries
are named by a hash of their source, the shared headers and the flags, and
live in ``build/unite_torch_kernels/`` at the repository root: a changed
source builds anew at its next use, an unchanged one loads at once. All
missing libraries are compiled in parallel, one ``nvcc`` per source.

Nothing here runs at import time: the CPU test suite imports every module
on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unite_torch_kernels"
SOURCES = ("short_attn_wgmma", "short_bwd_wgmma", "flash_fwd_wgmma",
           "flash_bwd_wgmma", "blocked_matmul_wgmma", "attn_fp32")
HEADERS = ("fused_qkv_common.cuh", "hopper.cuh", "attn_bwd_wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (name + ".cu",) + HEADERS:
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale library (in parallel) and return name -> path.

    Raises with the compiler's output when a build fails. The ptxas report
    (registers, shared memory, spills) is kept beside each library as
    ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in SOURCES}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.POINTER(ctypes.c_longlong)  # the views' strides
    # (B, S, H) and the head dim D after them
    signatures = {
        "unite_short_qkv_bwd": [p] * 10 + [ll, i, i, i, i, f, f, p],
        "unite_flash_fwd": [p, p, p, p, p, ll, i, i, i, i, f, p],
        "unite_short_qkv_fwd": [p, p, p, p, p, ll, i, i, i, i, f, p],
        "unite_short_grouped_fwd": [p] * 6 + [ll, i, i, i, i, f, p],
        "unite_flash_dq": [p] * 8 + [ll, i, i, i, i, f, f, p],
        "unite_flash_dkv": [p] * 8 + [ll, i, i, i, i, f, f, p],
        # the fp32 entries take the flash entries' argument lists
        "unite_fp32_attn_fwd": [p, p, p, p, p, ll, i, i, i, i, f, p],
        "unite_fp32_attn_dq": [p] * 8 + [ll, i, i, i, i, f, f, p],
        "unite_fp32_attn_dkv": [p] * 8 + [ll, i, i, i, i, f, f, p],
        "unite_short_grouped_dq": [p] * 8 + [ll, i, i, i, i, f, f, p],
        "unite_short_grouped_dkv": [p] * 9 + [ll, i, i, i, i, f, f, p],
        "unite_int8_matmul": [p, p, p, i, i, i, p],
        "unite_bf16_matmul": [p, p, p, i, i, i, p],
        "unite_int8_matmul_tile": [p, p, p, i, i, i, i, i, p],
        "unite_bf16_matmul_tile": [p, p, p, i, i, i, i, i, p],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
