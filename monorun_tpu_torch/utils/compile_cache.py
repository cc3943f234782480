"""The one root under which the port's builds live; the counterpart of
``monorun_tpu/utils/compile_cache.py``.

The JAX package keeps XLA's executables in a persistent compilation
cache. The port compiles too, but with ``nvcc`` and ``g++``: the CUDA
kernels (``ops/roi_align_cuda.py``) into ``<root>/torch_kernels/`` and
the native evaluator (``eval/_native``) into ``<root>/native/``. A
populated root makes a fresh process load instead of build.

The root is ``enable_compilation_cache``'s argument, else
``MONORUN_TORCH_CACHE_DIR`` (the counterpart of
``JAX_COMPILATION_CACHE_DIR``), else the repository's git-ignored
``build/``. Both build sites read it when they build, not when they are
imported, so a tool may point it at a fresh directory after import.
Entry points (``tools/``, ``demo/``) call ``enable_compilation_cache``
first thing, as the JAX package's do; a build with no root set yet sets
it the same way. Library code never names a root itself.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV = "MONORUN_TORCH_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / "build"

_root: Optional[Path] = None


def enable_compilation_cache(cache_dir: Optional[str | os.PathLike] = None) -> Path:
    """Sets the builds' root (the argument, else ``MONORUN_TORCH_CACHE_DIR``,
    else ``DEFAULT_CACHE_DIR``), makes the directory and returns it."""
    global _root
    path = Path(cache_dir or os.environ.get(ENV) or DEFAULT_CACHE_DIR).resolve()
    path.mkdir(parents=True, exist_ok=True)
    _root = path
    return path


def cache_root() -> Path:
    """The root set by ``enable_compilation_cache``; before any call, it
    makes that call with no argument."""
    return _root if _root is not None else enable_compilation_cache()


def kernels_dir() -> Path:
    """Where ``nvcc`` puts the CUDA kernels' libraries."""
    return cache_root() / "torch_kernels"


def native_dir() -> Path:
    """Where ``g++`` puts the native evaluator."""
    return cache_root() / "native"
