"""Build, binding and wrapper of the hand-written CUDA RoIAlign kernel
(``csrc/roi_align.cu``).

The kernel is compiled with ``nvcc`` at first use into a shared library
with a plain C interface under ``build/torch_kernels/`` at the repository
root, named by a hash of its source and flags, and loaded with
``ctypes``. A failed build, a refused launch or a bad argument raises;
there is no fallback to the plain version.

``roi_align_kernel.launches`` counts the kernel's launches in this
process (one per call that launches it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "roi_align.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
MAX_LEVELS = 5
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: the sample coordinates and
    # weights round exactly as the plain version's separate tensor ops do
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the RoIAlign kernel cannot be built")


class RoIAlignKernel:
    """Callable wrapper around the compiled kernel, with a launch count."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Compile (unless a library of this source is built) and load."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        src = _SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib_path = BUILD_DIR / f"libroi_align_{digest[:16]}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n"
                    f"{self.build_log}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.roi_align_forward.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.roi_align_forward.restype = ctypes.c_int
        lib.roi_align_error_string.argtypes = [ctypes.c_int]
        lib.roi_align_error_string.restype = ctypes.c_char_p
        self._lib = lib
        self.build_seconds = time.perf_counter() - t0
        return lib

    def __call__(
        self,
        features: Sequence[Tensor],   # per level (B, H_l, W_l, C), NHWC
        rois: Tensor,                 # (n, 5) float32
        strides: Sequence[int],
        out_size: Tuple[int, int],
        finest_scale: float,
        max_ratio: int,
        long_span_cap: Optional[float],
    ) -> Tensor:
        """Same function as ``roi_align.multilevel_roi_align``."""
        levels = len(features)
        f0 = features[0]
        if not 1 <= levels <= MAX_LEVELS or len(strides) != levels:
            raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride each")
        if f0.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"features must be float32 or bfloat16, not {f0.dtype}")
        if not f0.is_cuda:
            raise ValueError("the RoIAlign kernel needs CUDA tensors")
        B, C = f0.shape[0], f0.shape[-1]
        vec = 16 // f0.element_size()
        if C % vec:
            raise ValueError(f"channels ({C}) must be a multiple of {vec}")
        ptrs, dims = [], []
        for f in features:
            if f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C:
                raise ValueError("levels must all be (B, H, W, C) with one B and C")
            if f.dtype != f0.dtype or f.device != f0.device:
                raise ValueError("levels must share dtype and device")
            sb, sh, sw, sc = f.stride()
            if sc != 1 or f.data_ptr() % 16 or sb % vec or sh % vec or sw % vec:
                raise ValueError(
                    "each level needs unit channel stride, 16-byte alignment "
                    "and strides that are multiples of 16 bytes"
                )
            ptrs.append(f.data_ptr())
            dims += [f.shape[1], f.shape[2], sb, sh, sw]
        if (rois.dim() != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32
                or not rois.is_contiguous() or rois.device != f0.device):
            raise ValueError("rois must be a contiguous (n, 5) float32 tensor "
                             "on the features' device")
        oh, ow = out_size
        n = rois.shape[0]
        out = torch.empty((n, oh, ow, C), dtype=f0.dtype, device=f0.device)
        if n == 0:
            return out
        lib = self.build()
        inv_strides = (ctypes.c_float * levels)(*[1.0 / s for s in strides])
        with torch.cuda.device(f0.device):
            stream = torch.cuda.current_stream(f0.device).cuda_stream
            rc = lib.roi_align_forward(
                int(f0.dtype == torch.bfloat16), levels,
                (ctypes.c_void_p * levels)(*ptrs),
                (ctypes.c_longlong * len(dims))(*dims),
                inv_strides,
                rois.data_ptr(), out.data_ptr(),
                n, B, C, oh, ow, int(max_ratio),
                float(finest_scale),
                float(long_span_cap * strides[0]) if long_span_cap else 0.0,
                stream,
            )
        if rc != 0:
            raise RuntimeError(
                "RoIAlign kernel launch failed: "
                + lib.roi_align_error_string(rc).decode()
            )
        self.launches += 1
        return out


roi_align_kernel = RoIAlignKernel()
