"""Build, bindings and wrappers of the hand-written CUDA RoIAlign kernels
(``csrc/*.cu``).

A source under ``csrc/`` is compiled with ``nvcc`` when a kernel of it is
first bound (``build_all(stems)``: only the sources asked for, one process
per source, all started together), into shared libraries with a plain C
interface under ``torch_kernels/<hash>/`` in the builds' root
(``utils/compile_cache.py``, read when it builds; the hash covers every
source, header and flag), and loaded with ``ctypes``. A failed build, a
refused launch or a bad argument raises; there is no fallback to a plain
version. Processes that start together (the ranks of a data-parallel run)
build one after another under a file lock on the build directory, so the
later ones load what the first built.

Kernels, each with a ``launches`` count (one per call that launches it):

* ``roi_align_kernel`` (``csrc/roi_align.cu``): the direct kernel, port of
  the band and sorted TPU kernels (``RoIAlignKernel(source=...)`` binds
  another build of the same C interface, for an A/B on the card);
* ``roi_align_backward_kernel`` (``csrc/roi_align_bwd.cu``): its gradient
  with respect to the levels and the RoIs (a per-RoI kernel, a bucket sort
  and a tile kernel that writes each level cell once; no atomics, so a
  call is bitwise repeatable); ``roi_align_direct`` is the two as a
  ``torch.autograd.Function``, the one differentiable kernel route;
* ``tile_kernel`` (``csrc/roi_align_tile.cu``): per-RoI tier tiles;
* ``band_tiered_kernel`` (``csrc/roi_align_band.cu``): tier-uniform band
  blocks;
* ``band_packed_kernel`` and ``band_matmul_kernel``
  (``csrc/roi_align_mma.cu``): band blocks with per-RoI tiers, and whole
  band panels.

The four staged kernels run one staged core, ``csrc/roi_align_ring.cuh``
(row products on tensor cores); their wrappers also report the loaded
build's attributes and a call's launch shape. ``StagedKernel.with_source``
binds another build of a staged kernel's C interface, for an A/B.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.compile_cache import kernels_dir

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
MAX_LEVELS = 5
MAX_RATIO = 16       # the direct kernel's samples per axis: one lane each
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: the sample coordinates and
    # weights round exactly as the plain version's separate tensor ops do
    # (the direct kernel's channel sums call __fmaf_rn explicitly)
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
    raise RuntimeError("nvcc not found: the RoIAlign kernels cannot be built")


def _start_nvcc(src: Path, lib: Path):
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    # headers: the source's own directory first, then csrc/
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish_nvcc(jobs) -> Tuple[str, list]:
    """Waits for every (lib, tmp, process); returns the joined log and the
    libraries that failed."""
    failed, logs = [], []
    for lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {lib.name}\n{out}")
        if proc.returncode:
            failed.append(lib.name)
        else:
            os.replace(tmp, lib)
    return "\n".join(logs), failed


@contextlib.contextmanager
def _locked(out_dir: Path):
    """An exclusive lock on ``out_dir`` for the body of a ``with`` (the
    file's close, or the process's end, releases it)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build_source(src: Path) -> Tuple[ctypes.CDLL, str]:
    """One source built alone with the same flags (into a directory named
    by the hash of its content and of the headers in its directory and in
    csrc/), and nvcc's log. Headers it includes come from its own
    directory, else from csrc/."""
    src = Path(src)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    for path in sorted(CSRC.glob("*.cuh")) + sorted(src.parent.glob("*.cuh")):
        digest.update(path.name.encode() + path.read_bytes())
    out_dir = kernels_dir() / f"one-{digest.hexdigest()[:16]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{src.stem}.so"
    log = ""
    if not lib.exists():
        log, failed = _finish_nvcc([_start_nvcc(src, lib)])
        if failed:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return ctypes.CDLL(str(lib)), log


class KernelBuild:
    """The libraries of the sources under ``csrc/``, each built at most once
    per process: ``build_all(stems)`` builds (those not yet in the build
    directory, together) and loads the named ones, or every one when given
    none, and returns them by source stem. ``libs`` holds every library
    loaded so far, ``built`` the stems this process ran ``nvcc`` on (one
    job each), ``log`` nvcc's and ptxas's output (registers, spills) and
    ``seconds`` the wall time of the last call that built or loaded."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.built: list = []
        self.log = ""
        self.seconds: Optional[float] = None
        self._lock = threading.Lock()

    @staticmethod
    def stems() -> Tuple[str, ...]:
        """Every source's stem."""
        return tuple(s.stem for s in sorted(CSRC.glob("*.cu")))

    def __call__(self, stems: Optional[Sequence[str]] = None) -> Dict[str, ctypes.CDLL]:
        known = self.stems()
        stems = known if stems is None else tuple(stems)
        unknown = sorted(set(stems) - set(known))
        if unknown:
            raise ValueError(f"no source csrc/<stem>.cu for {unknown}; the stems are {known}")
        with self._lock:
            missing = [s for s in stems if s not in self.libs]
            if missing:
                self._load(missing)
            return {s: self.libs[s] for s in stems}

    def _load(self, stems: Sequence[str]) -> None:
        t0 = time.perf_counter()
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(CSRC.iterdir()):
            digest.update(path.name.encode() + path.read_bytes())
        out_dir = kernels_dir() / digest.hexdigest()[:16]
        with _locked(out_dir):
            todo = [s for s in stems if not (out_dir / f"lib{s}.so").exists()]
            jobs = [_start_nvcc(CSRC / f"{s}.cu", out_dir / f"lib{s}.so") for s in todo]
            log, failed = _finish_nvcc(jobs)
        self.built += todo
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        if log:
            self.log = "\n".join(filter(None, (self.log, log)))
        for s in stems:
            self.libs[s] = ctypes.CDLL(str(out_dir / f"lib{s}.so"))
        self.seconds = time.perf_counter() - t0


build_all = KernelBuild()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _level_args(features: Sequence[Tensor], strides: Sequence[int], max_ratio: int):
    """The checked level pointers and (H, W, batch, row, column strides) of
    the direct kernels' C interface."""
    levels = len(features)
    f0 = features[0]
    if not 1 <= levels <= MAX_LEVELS or len(strides) != levels:
        raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride each")
    if not 1 <= max_ratio <= MAX_RATIO:
        raise ValueError(f"max_ratio must be 1..{MAX_RATIO}, not {max_ratio}")
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
        if ((f.shape[1] - 1) * sh + (f.shape[2] - 1) * sw + C) * f.element_size() >= 2 ** 31:
            raise ValueError("a level's image must span fewer than 2^31 bytes")
        ptrs.append(f.data_ptr())
        dims += [f.shape[1], f.shape[2], sb, sh, sw]
    return ptrs, dims


class RoIAlignKernel:
    """Callable wrapper around the direct kernel, with a launch count;
    ``source`` builds another file of the same C interface instead (an
    earlier version of ``csrc/roi_align.cu``, for an A/B)."""

    def __init__(self, source: Optional[Path] = None):
        self.launches = 0
        self.source = source
        self.build_log = ""
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Build its library (unless built) and bind this kernel."""
        if self._lib is not None:
            return self._lib
        if self.source is None:
            lib = build_all(["roi_align"])["roi_align"]
            self.build_log = build_all.log
        else:
            lib, self.build_log = build_source(self.source)
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
        return lib

    def empty_launch(self, device=None) -> None:
        """One launch of an empty kernel on the current stream (not
        counted): the fixed cost of a launch, for timing beside a call."""
        lib = self.build()
        lib.roi_align_empty.argtypes = [ctypes.c_void_p]
        lib.roi_align_empty.restype = ctypes.c_int
        dev = torch.device("cuda") if device is None else device
        with torch.cuda.device(dev):
            rc = lib.roi_align_empty(_stream(dev))
        if rc != 0:
            raise RuntimeError("empty launch failed: "
                               + lib.roi_align_error_string(rc).decode())

    def attributes(self) -> Dict[str, Dict[str, int]]:
        """Registers and local memory bytes (spills and stack) per thread of
        the forward kernel in each dtype, from the loaded build."""
        lib = self.build()
        lib.roi_align_attributes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_int)]
        lib.roi_align_attributes.restype = ctypes.c_int
        usage = {}
        for name, is_bf16 in (("bfloat16", 1), ("float32", 0)):
            regs, local = ctypes.c_int(), ctypes.c_int()
            rc = lib.roi_align_attributes(is_bf16, ctypes.byref(regs), ctypes.byref(local))
            if rc != 0:
                raise RuntimeError("kernel attributes query failed: "
                                   + lib.roi_align_error_string(rc).decode())
            usage[name] = dict(registers=regs.value, local_bytes=local.value)
        return usage

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
        f0 = features[0]
        levels = len(features)
        ptrs, dims = _level_args(features, strides, max_ratio)
        B, C = f0.shape[0], f0.shape[-1]
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
            rc = lib.roi_align_forward(
                int(f0.dtype == torch.bfloat16), levels,
                (ctypes.c_void_p * levels)(*ptrs),
                (ctypes.c_longlong * len(dims))(*dims),
                inv_strides,
                rois.data_ptr(), out.data_ptr(),
                n, B, C, oh, ow, int(max_ratio),
                float(finest_scale),
                float(long_span_cap * strides[0]) if long_span_cap else 0.0,
                _stream(f0.device),
            )
        if rc != 0:
            raise RuntimeError(
                "RoIAlign kernel launch failed: "
                + lib.roi_align_error_string(rc).decode()
            )
        self.launches += 1
        return out


roi_align_kernel = RoIAlignKernel()


class BackwardIndex(NamedTuple):
    """The backward's index pass on one call (``RoIAlignBackwardKernel.index``):
    what the per-RoI kernel hands the tile kernel, and the bucket sort."""

    lists: Tensor     # (n, oh + ow, 2 max_ratio, 2) int32: tap, weight's bits (tap -1: unused)
    rects: Tensor     # (n, 4) int32: rows [r0, r1), columns [r2, r3) its taps reach
    keys: Tensor      # (n,) int32: image * levels + level
    order: Tensor     # (n,) int32: the RoIs by key, in RoI order within a key
    offsets: Tensor   # (B * levels + 1,) int32: each key's first place in order


class RoIAlignBackwardKernel:
    """Callable wrapper around the direct kernel's backward
    (``csrc/roi_align_bwd.cu``), with a launch count: the gradients of
    ``RoIAlignKernel``'s function with respect to the levels and the RoIs.

    A call launches up to three kernels, each counted: the per-RoI kernel
    (the RoI gradient, and the tap lists, key and rectangle of each RoI
    when the levels' gradient is asked for), then for the levels' gradient
    the bucket sort (without the RoIs whose output gradient is zero: they
    add exact zeros) and the tile kernel, which writes every cell of the
    per-level outputs (``torch.empty``, the levels' dtype) once. So 3
    launches when both gradients are asked for, 3 for the levels alone, 1
    for the RoIs alone, 0 for no RoIs. ``source`` builds another file of
    the same C interface instead (an earlier version of
    ``csrc/roi_align_bwd.cu``, for an A/B)."""

    def __init__(self, source: Optional[Path] = None):
        self.launches = 0
        self.source = source
        self.build_log = ""
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Build its library (unless built) and bind this kernel."""
        if self._lib is not None:
            return self._lib
        if self.source is None:
            lib = build_all(["roi_align_bwd"])["roi_align_bwd"]
            self.build_log = build_all.log
        else:
            lib, self.build_log = build_source(self.source)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.roi_align_backward_rois.argtypes = [
            I, I, ctypes.POINTER(P), ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(F),
            P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, P,
        ]
        lib.roi_align_backward_buckets.argtypes = [P, P, I, I, I, P, P, P]
        lib.roi_align_backward_levels.argtypes = [
            I, I, ctypes.POINTER(P), ctypes.POINTER(ctypes.c_longlong),
            P, P, P, P, P, I, I, I, I, I, P,
        ]
        lib.roi_align_backward_shape.argtypes = [I] * 3 + [ctypes.POINTER(I)] * 2
        lib.roi_align_backward_tile.argtypes = [I] + [ctypes.POINTER(I)] * 3
        lib.roi_align_backward_attributes.argtypes = [I, I] + [ctypes.POINTER(I)] * 2
        for fn in ("roi_align_backward_rois", "roi_align_backward_buckets",
                   "roi_align_backward_levels", "roi_align_backward_shape",
                   "roi_align_backward_tile", "roi_align_backward_attributes"):
            getattr(lib, fn).restype = I
        lib.roi_align_bwd_error_string.argtypes = [I]
        lib.roi_align_bwd_error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed: "
                               + self._lib.roi_align_bwd_error_string(rc).decode())

    def attributes(self) -> Dict[str, Dict[str, int]]:
        """Registers and local memory bytes per thread of each backward
        kernel (the per-RoI kernel, the bucket sort, the tile kernel) in
        each dtype, from the loaded build."""
        lib = self.build()
        usage = {}
        for kernel, name in ((0, "rois"), (1, "buckets"), (2, "levels")):
            for dtype, is_bf16 in (("bfloat16", 1), ("float32", 0)):
                if kernel == 1 and not is_bf16:
                    continue
                regs, local = ctypes.c_int(), ctypes.c_int()
                self._check(lib.roi_align_backward_attributes(
                    kernel, is_bf16, ctypes.byref(regs), ctypes.byref(local)),
                    "attributes query")
                usage[name if kernel == 1 else f"{name} {dtype}"] = dict(
                    registers=regs.value, local_bytes=local.value)
        return usage

    def launch_shape(self, n: int, out_size: Tuple[int, int]) -> Dict[str, int]:
        """Warps per block and blocks per RoI (along blockIdx.y) of the
        per-RoI kernel on a call."""
        lib = self.build()
        warps, split = ctypes.c_int(), ctypes.c_int()
        self._check(lib.roi_align_backward_shape(n, out_size[0], out_size[1],
                                                 ctypes.byref(warps), ctypes.byref(split)),
                    "shape query")
        return dict(warps=warps.value, split=split.value)

    def tile(self, dtype: torch.dtype) -> Dict[str, int]:
        """The tile kernel's tile in ``dtype``: rows, cells per row, and
        channels per block."""
        lib = self.build()
        rows, cols, chans = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._check(lib.roi_align_backward_tile(int(dtype == torch.bfloat16), ctypes.byref(rows),
                                                ctypes.byref(cols), ctypes.byref(chans)),
                    "tile query")
        return dict(rows=rows.value, cols=cols.value, channels=chans.value)

    def _check_call(self, features, rois, grad_out, strides, out_size, max_ratio):
        f0 = features[0]
        ptrs, dims = _level_args(features, strides, max_ratio)
        n = rois.shape[0]
        if (rois.dim() != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32
                or not rois.is_contiguous() or rois.device != f0.device):
            raise ValueError("rois must be a contiguous (n, 5) float32 tensor "
                             "on the features' device")
        shape = (n, *out_size, f0.shape[-1])
        if grad_out is not None and (
                tuple(grad_out.shape) != shape or grad_out.dtype != f0.dtype
                or not grad_out.is_contiguous() or grad_out.device != f0.device
                or grad_out.data_ptr() % 16):
            raise ValueError("grad_out must be a contiguous, 16-byte aligned "
                             f"{shape} tensor in the levels' dtype and device")
        return ptrs, dims

    def _rois(self, features, rois, grad_out, strides, out_size, finest_scale, max_ratio,
              long_span_cap, ptrs, dims, partial, index, live=None):
        """One launch of the per-RoI kernel: ``partial`` (split, n, 4) the
        RoI gradient's block sums, ``index`` (lists, rects, keys) its
        outputs for the tile kernel, ``live`` (split, n) whether each
        block's bins have a nonzero output gradient (given ``grad_out``);
        any may be None."""
        lib = self.build()
        f0 = features[0]
        levels = len(features)
        inv_strides = (ctypes.c_float * levels)(*[1.0 / s for s in strides])
        lists, rects, keys = index if index is not None else (None, None, None)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        with torch.cuda.device(f0.device):
            rc = lib.roi_align_backward_rois(
                int(f0.dtype == torch.bfloat16), levels,
                (ctypes.c_void_p * levels)(*ptrs), (ctypes.c_longlong * len(dims))(*dims),
                inv_strides, rois.data_ptr(), ptr(grad_out), ptr(partial), ptr(live), ptr(lists),
                ptr(rects), ptr(keys), rois.shape[0], f0.shape[0], f0.shape[-1],
                out_size[0], out_size[1], int(max_ratio), float(finest_scale),
                float(long_span_cap * strides[0]) if long_span_cap else 0.0,
                _stream(f0.device))
        self._check(rc, "RoIAlign backward per-RoI kernel launch")
        self.launches += 1

    def _index(self, features, rois, strides, out_size, finest_scale, max_ratio,
               long_span_cap, ptrs, dims, grad_out=None, partial=None) -> BackwardIndex:
        """The per-RoI kernel with its index outputs (and the RoI
        gradient's sums when ``partial`` is given), then the bucket sort.
        Given ``grad_out``, the RoIs whose output gradient is zero, which
        add exact zeros, stay out of the buckets."""
        f0 = features[0]
        n, dev = rois.shape[0], f0.device
        n_keys = f0.shape[0] * len(features)
        lists = torch.empty((n, sum(out_size), 2 * max_ratio, 2), dtype=torch.int32,
                            device=dev)
        rects = torch.empty((n, 4), dtype=torch.int32, device=dev)
        keys = torch.empty((n,), dtype=torch.int32, device=dev)
        live = None
        if grad_out is not None:
            live = torch.empty((partial.shape[0] if partial is not None else 1, n),
                               dtype=torch.int32, device=dev)
        self._rois(features, rois, grad_out, strides, out_size, finest_scale, max_ratio,
                   long_span_cap, ptrs, dims, partial, (lists, rects, keys), live)
        order = torch.empty((n,), dtype=torch.int32, device=dev)
        offsets = torch.empty((n_keys + 1,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = self._lib.roi_align_backward_buckets(
                keys.data_ptr(), live.data_ptr() if live is not None else None,
                live.shape[0] if live is not None else 1, n, n_keys, order.data_ptr(),
                offsets.data_ptr(), _stream(dev))
        self._check(rc, "RoIAlign backward bucket sort launch")
        self.launches += 1
        return BackwardIndex(lists, rects, keys, order, offsets)

    def index(
        self,
        features: Sequence[Tensor],
        rois: Tensor,
        strides: Sequence[int],
        out_size: Tuple[int, int],
        finest_scale: float,
        max_ratio: int,
        long_span_cap: Optional[float],
    ) -> BackwardIndex:
        """The index pass alone (two launches; the plain statement of its
        rule is ``roi_align.backward_index``)."""
        ptrs, dims = self._check_call(features, rois, None, strides, out_size, max_ratio)
        if rois.shape[0] == 0:
            raise ValueError("the index pass needs at least one RoI")
        return self._index(features, rois, strides, out_size, finest_scale, max_ratio,
                           long_span_cap, ptrs, dims)

    def __call__(
        self,
        features: Sequence[Tensor],   # per level (B, H_l, W_l, C), as the forward's
        rois: Tensor,                 # (n, 5) float32
        grad_out: Tensor,             # (n, oh, ow, C) in the features' dtype
        strides: Sequence[int],
        out_size: Tuple[int, int],
        finest_scale: float,
        max_ratio: int,
        long_span_cap: Optional[float],
        need_features: bool = True,
        need_rois: bool = True,
    ) -> Tuple[Optional[list], Optional[Tensor]]:
        """(d levels in the levels' dtype, d rois (n, 5) float32 with a zero
        batch column); either is None when not asked for."""
        f0 = features[0]
        ptrs, dims = self._check_call(features, rois, grad_out, strides, out_size, max_ratio)
        n, dev = rois.shape[0], f0.device
        if n == 0:
            return ([torch.zeros(f.shape, dtype=f.dtype, device=dev) for f in features]
                    if need_features else None,
                    torch.zeros((0, 5), dtype=torch.float32, device=dev) if need_rois else None)
        partial = None
        if need_rois:
            split = self.launch_shape(n, out_size)["split"]
            partial = torch.empty((split, n, 4), dtype=torch.float32, device=dev)
        d_levels = None
        if need_features:
            ix = self._index(features, rois, strides, out_size, finest_scale, max_ratio,
                             long_span_cap, ptrs, dims, grad_out, partial)
            d_levels = [torch.empty(f.shape, dtype=f.dtype, device=dev) for f in features]
            hw = [v for f in features for v in (f.shape[1], f.shape[2])]
            with torch.cuda.device(dev):
                rc = self._lib.roi_align_backward_levels(
                    int(f0.dtype == torch.bfloat16), len(features),
                    (ctypes.c_void_p * len(features))(*[d.data_ptr() for d in d_levels]),
                    (ctypes.c_longlong * len(hw))(*hw), grad_out.data_ptr(),
                    ix.lists.data_ptr(), ix.rects.data_ptr(), ix.order.data_ptr(),
                    ix.offsets.data_ptr(), f0.shape[0], f0.shape[-1], out_size[0],
                    out_size[1], int(max_ratio), _stream(dev))
            self._check(rc, "RoIAlign backward tile kernel launch")
            self.launches += 1
        else:
            self._rois(features, rois, grad_out, strides, out_size, finest_scale, max_ratio,
                       long_span_cap, ptrs, dims, partial, None)
        d_rois = (torch.cat([partial.new_zeros(n, 1), partial.sum(0)], 1)
                  if need_rois else None)
        return d_levels, d_rois


roi_align_backward_kernel = RoIAlignBackwardKernel()


class _DirectAlign(torch.autograd.Function):
    """The direct kernel as a differentiable function of the levels and the
    RoIs: forward ``roi_align_kernel``, backward
    ``roi_align_backward_kernel``."""

    @staticmethod
    def forward(ctx, spec, rois, *features):
        ctx.spec = spec
        ctx.save_for_backward(rois, *features)
        return roi_align_kernel(features, rois, *spec)

    @staticmethod
    def backward(ctx, grad_out):
        rois, *features = ctx.saved_tensors
        need_rois = ctx.needs_input_grad[1]
        need_features = any(ctx.needs_input_grad[2:])
        d_levels, d_rois = roi_align_backward_kernel(
            features, rois, grad_out.contiguous(), *ctx.spec,
            need_features=need_features, need_rois=need_rois)
        d_levels = d_levels or [None] * len(features)
        return (None, d_rois, *[d if ctx.needs_input_grad[2 + i] else None
                                for i, d in enumerate(d_levels)])


def roi_align_direct(
    features: Sequence[Tensor],   # per level (B, H_l, W_l, C), NHWC, CUDA
    rois: Tensor,                 # (n, 5)
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float,
    max_ratio: int,
    long_span_cap: Optional[float],
) -> Tensor:
    """The direct kernel with its gradient: the same function as
    ``roi_align.multilevel_roi_align``, differentiable in the levels and
    the RoIs on CUDA tensors (the backward is ``csrc/roi_align_bwd.cu``).
    CPU tensors raise: the plain version is ``multilevel_roi_align``."""
    if not (rois.is_cuda and all(f.is_cuda for f in features)):
        raise ValueError("the direct RoIAlign kernel needs CUDA tensors; on the CPU "
                         "use roi_align.multilevel_roi_align")
    spec = (tuple(strides), tuple(out_size), float(finest_scale), int(max_ratio),
            long_span_cap)
    return _DirectAlign.apply(spec, rois.float().contiguous(),
                              *[f.contiguous() for f in features])


# ---- staged kernels ---------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_BUFS = [_I, ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I), _I]


class StagedKernel:
    """Wrapper of one staged kernel (prepared inputs from
    ``roi_align_tile.prepare_tile_call`` or
    ``roi_align_band.prepare_band_call``), with a launch count. ``lib`` is
    the stem of its source under ``csrc/``; ``source`` builds another file
    with the same C interface instead (an earlier version, for an A/B)."""

    def __init__(self, name: str, lib: str, symbol: str, argtypes,
                 source: Optional[Path] = None):
        self.name = name
        self.lib = lib
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None
        self._err = None

    def with_source(self, source: Path) -> "StagedKernel":
        """The same wrapper bound to a build of ``source``."""
        return StagedKernel(self.name, self.lib, self.symbol, self.argtypes, Path(source))

    def _load(self) -> ctypes.CDLL:
        if self._lib is None:
            if self.source is None:
                self._lib = build_all([self.lib])[self.lib]
                self.build_log = build_all.log
            else:
                self._lib, self.build_log = build_source(self.source)
        return self._lib

    def build(self) -> ctypes.CDLL:
        """Build (unless built) and bind this kernel."""
        self._bind()
        return self._lib

    def _bind(self):
        if self._fn is None:
            lib = self._load()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.lib}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def _entry(self, suffix: str):
        """The C entry ``<symbol without _forward>_<suffix>`` (every staged
        kernel exports ``attributes`` and ``shape``)."""
        self._bind()
        return getattr(self._load(), self.symbol.removesuffix("_forward") + "_" + suffix)

    def attributes(self) -> Dict[str, Dict[str, int]]:
        """Registers and local memory bytes per thread and static shared
        memory bytes per block of the loaded build's kernel in each dtype
        (the most over the dtype's builds: float32 has one for 8 and one
        for 16 output columns per block), from ``cudaFuncGetAttributes``."""
        fn = self._entry("attributes")
        fn.argtypes = [_I] + [ctypes.POINTER(_I)] * 3
        fn.restype = _I
        usage = {}
        for dname, is_bf16 in (("bfloat16", 1), ("float32", 0)):
            regs, local, static = _I(), _I(), _I()
            rc = fn(is_bf16, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(static))
            if rc != 0:
                raise RuntimeError(f"{self.name} attributes query failed: "
                                   + self._err(rc).decode())
            usage[dname] = dict(registers=regs.value, local_bytes=local.value,
                                static_smem=static.value)
        return usage

    def launch_shape(self, dtype: torch.dtype, kroi: int, out_size: int,
                     tw: int) -> Dict[str, int]:
        """The launch shape the C launcher picks for a call (the tile
        kernel's ``kroi`` is 1): channels per block, columns per ring
        stage, m-tiles per block, blocks along A's rows and along the
        output columns per kroi-block, slots per block, dynamic shared
        memory bytes, threads, and resident blocks per SM
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        fn = self._entry("shape")
        fn.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
        fn.restype = _I
        vals = (_I * 9)()
        rc = fn(int(dtype == torch.bfloat16), kroi, out_size, tw, vals)
        if rc != 0:
            raise RuntimeError(f"{self.name} shape query failed: " + self._err(rc).decode())
        keys = ("channels", "stage_cols", "m_tiles", "m_groups", "j_groups", "slots",
                "smem_bytes", "threads", "blocks_per_sm")
        return dict(zip(keys, list(vals)))

    @staticmethod
    def _buffers(bufs: Sequence[Tensor]):
        b0 = bufs[0]
        if b0.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"features must be float32 or bfloat16, not {b0.dtype}")
        if not b0.is_cuda:
            raise ValueError("the staged RoIAlign kernels need CUDA tensors")
        if not 1 <= len(bufs) <= 2 * MAX_LEVELS:
            raise ValueError(f"need 1..{2 * MAX_LEVELS} level buffers")
        C = b0.shape[-1]
        for b in bufs:
            if (b.dim() != 3 or b.shape[-1] != C or b.dtype != b0.dtype
                    or b.device != b0.device or not b.is_contiguous() or b.data_ptr() % 16):
                raise ValueError("level buffers must be contiguous 16-byte aligned "
                                 "(rows, cols, C) tensors of one dtype, C and device")
        if (C * b0.element_size()) % 16:
            raise ValueError(f"channels ({C}) must fill 16-byte rows")
        k = len(bufs)
        return [int(b0.dtype == torch.bfloat16), (_P * k)(*[b.data_ptr() for b in bufs]),
                (_I * k)(*[b.shape[0] for b in bufs]), (_I * k)(*[b.shape[1] for b in bufs]),
                k]

    @staticmethod
    def _ints(device, **arrays) -> list:
        for name, t in arrays.items():
            if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
                raise ValueError(f"{name} must be a contiguous int32 tensor on {device}")
        return [t.data_ptr() for t in arrays.values()]

    @staticmethod
    def _weights(bufs, **arrays) -> list:
        for name, t in arrays.items():
            if t.dtype != bufs[0].dtype or not t.is_contiguous() or t.device != bufs[0].device:
                raise ValueError(f"{name} must be contiguous in the features' dtype and device")
        return [t.data_ptr() for t in arrays.values()]

    def _launch(self, device, out, args) -> Tensor:
        fn = self._bind()
        with torch.cuda.device(device):
            rc = fn(*args, _stream(device))
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               + self._err(rc).decode())
        self.launches += 1
        return out

    def __call__(self, call) -> Tensor:
        bufs = call.bufs if hasattr(call, "bufs") else call.pyramid.bufs
        head = self._buffers(bufs)
        dev = bufs[0].device
        Y, X = (call.Y, call.X) if hasattr(call, "Y") else (call.geo.Y, call.geo.X)
        oh, ow = Y.shape[1], X.shape[1]
        if oh != ow:
            raise ValueError("dual-orientation tiles require square outputs")
        out = torch.empty((call.n, oh, ow, bufs[0].shape[-1]), dtype=bufs[0].dtype,
                          device=dev)
        if call.n == 0:
            return out
        C = bufs[0].shape[-1]
        w = self._weights(bufs, Y=Y, X=X)
        if self.name == "tile":
            g = call.geo
            ints = self._ints(dev, buf_id=g.buf_id, r0=g.r0, c0=g.c0, nrb=g.nrb, ncb=g.ncb,
                              trans=g.tmask.int().contiguous())
            args = [*head, *ints, *w, out.data_ptr(), call.n, C, oh, ow, Y.shape[2],
                    X.shape[2]]
        else:
            if call.mode != self.name.removeprefix("band_"):
                raise ValueError(f"a {call.mode!r} band call cannot run the "
                                 f"{self.name} kernel")
            nblk = call.blk_buf.shape[0]
            if call.mode == "tiered":
                ints = self._ints(dev, rw0=call.row0, c0=call.col0, dst=call.dst,
                                  trans=call.trans, blk_buf=call.blk_buf,
                                  blk_ncb=call.blk_ncb)
            elif call.mode == "packed":
                ints = self._ints(dev, rw0=call.row0, c0=call.col0, ncb=call.ncb,
                                  dst=call.dst, trans=call.trans, blk_buf=call.blk_buf)
            elif call.mode == "matmul":
                ints = self._ints(dev, c0rel=call.col0, dst=call.dst, trans=call.trans,
                                  blk_buf=call.blk_buf, blk_start=call.blk_start,
                                  blk_po=call.blk_po, blk_act=call.blk_act)
            args = [*head, *ints, *w, out.data_ptr(), nblk, call.kroi, C, oh, ow]
            if call.mode == "matmul":
                args += [call.tw, int(call.t1_dtype is not None)]
                if call.t1_dtype not in (None, torch.bfloat16):
                    raise ValueError("t1 is float32 (None) or bfloat16")
            else:
                args += [call.th, call.tw]
        return self._launch(dev, out, args)


tile_kernel = StagedKernel("tile", "roi_align_tile", "roi_align_tile_forward",
                           _BUFS + [_P] * 6 + [_P] * 3 + [_I] * 6 + [_P])
band_tiered_kernel = StagedKernel("band_tiered", "roi_align_band",
                                  "roi_align_band_tiered_forward",
                                  _BUFS + [_P] * 6 + [_P] * 3 + [_I] * 7 + [_P])
band_packed_kernel = StagedKernel("band_packed", "roi_align_mma",
                                  "roi_align_band_packed_forward",
                                  _BUFS + [_P] * 6 + [_P] * 3 + [_I] * 7 + [_P])
band_matmul_kernel = StagedKernel("band_matmul", "roi_align_mma",
                                  "roi_align_band_matmul_forward",
                                  _BUFS + [_P] * 7 + [_P] * 3 + [_I] * 7 + [_P])

STAGED_KERNELS = (tile_kernel, band_tiered_kernel, band_packed_kernel, band_matmul_kernel)
# every kernel under its name on ``chip_smoke.py``'s kernels line
KERNELS = {"roi_align": roi_align_kernel, "roi_align_backward": roi_align_backward_kernel,
           **{f"roi_align_{k.name}": k for k in STAGED_KERNELS}}


def launch_counts() -> Dict[str, int]:
    """Every kernel's ``launches``, by its name in ``KERNELS``."""
    return {name: k.launches for name, k in KERNELS.items()}
