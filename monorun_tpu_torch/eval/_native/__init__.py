"""ctypes binding + on-demand g++ build of the native eval kernels.

The library is built at first use into the repository's git-ignored
``build/native/`` (beside the CUDA kernels' ``build/torch_kernels/``),
under a name that carries a hash of the source, so an edited source
builds anew. Each build writes a temporary file of its own and moves it
into place with ``os.replace``: processes that build at once never load
a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "kitti_stats.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libkitti_stats_{sys.platform}_{digest}.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.kitti_tp_scores.restype = ctypes.c_int
    lib.kitti_tp_scores.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, i32p, i32p,
        ctypes.c_float, f32p,
    ]
    lib.kitti_stats_thresholds.restype = None
    lib.kitti_stats_thresholds.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, f32p, f32p,
        ctypes.c_int, i32p, i32p, ctypes.c_int, ctypes.c_float, f32p,
        ctypes.c_int, ctypes.c_int, f32p,
    ]
    _lib = lib
    return _lib
