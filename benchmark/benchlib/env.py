"""The run's surroundings: build caches inside the checkout, the device
check, the module check, the card's name and power limit, the result
line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Sequence

from .spec import HERE

# every build and kernel cache of the program, at fixed paths inside the
# checkout (git-ignored by benchmark/.gitignore), so that only a cell's
# first run in a checkout builds
BUILD = HERE / "build"
CACHES = {
    "MONORUN_TORCH_CACHE_DIR": BUILD / "monorun",
    "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
    "TRITON_CACHE_DIR": BUILD / "triton",
    "CUDA_CACHE_PATH": BUILD / "nv_compute_cache",
}

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "monorun_tpu")


def set_caches() -> None:
    for key, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    # a library that would load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules: Sequence[str] = ()) -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of ``FORBIDDEN``: ``monorun_tpu_torch`` passes."""
    names = modules or list(sys.modules)
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


class Laps:
    """Seconds between calls, by name: where set-up goes."""

    def __init__(self):
        self.laps: Dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


class NoDevice(RuntimeError):
    pass


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no result")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"torch sees {torch.cuda.device_count()}: no result")


def card_line() -> str:
    """``name, power.limit`` of every card as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_block(chips: int, peak_bytes: int) -> Dict[str, Any]:
    import torch

    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                memory_peak_bytes=int(peak_bytes))


def note(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def emit(result: Dict[str, Any], checks: List[Dict[str, Any]]) -> None:
    """The checks on standard error, last there, and the result's line
    last on standard output, with the checks under its last key."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    out = dict(result)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
