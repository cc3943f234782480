"""Cold-start breakdown of the port's serving path: imports / CUDA context /
init_detector / precast / inputs / kernel build / first and second request
(the counterpart of ``tools/cold_profile.py``).

    python -m monorun_tpu_torch.tools.cold_profile [batch] [align_impl] [stage] \\
        [--device cuda] [--cfg-options ...] [--cache-dir DIR] [--warm] [--save FILE]

``align_impl`` (``auto | gather | sorted | band | bandmm``) sets
``MONORUN_ALIGN_IMPL``; ``stage`` is ``full`` (the whole forward) or
``backbone`` (backbone and FPN alone). Serves kitti_multiclass at batch
``batch`` (default 8) with seeded random weights. The JAX tool reproduces
a fresh environment's compile; the port's compile is ``nvcc`` on the CUDA
kernels, so the builds' root (``utils/compile_cache.py``) is pointed at a
fresh temporary directory, removed at the end, unless ``--cache-dir``
names one (a populated one then loads what it holds); ``main`` gives the
process its earlier root back when it returns. Inputs are made on
the device, as the JAX tool does, and the host upload is timed apart.

Each mark prints its seconds and the running total: imports, backend init
(the CUDA context), init_detector, precast (the session's cast and move
to the device), on-device inputs, kernel build (the serving path's
libraries, ``warm_start.serving_stems``, built or loaded), first
exec+fetch, second exec+fetch, then the checksum of both and the host
upload. With ``--warm`` the session comes from ``init_inference(warm=True)``
instead (its weights are the same draw): the marks are imports, backend
init, init_inference (warm), on-device inputs, first and second request,
and ``warm_start``'s pieces are printed. ``--save FILE`` keeps the first
request's detections (``torch.save``, on the CPU). ``main(argv)`` returns
the figures, with the ``nvcc`` jobs the process started (and those during
its first request) and the kernels' launches.

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, Optional, Sequence  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ..apis.inference import (  # noqa: E402
    InferenceSession, init_inference, resolve_device, upload,
)
from ..config import apply_overrides, get_config  # noqa: E402
from ..models.detector import init_detector  # noqa: E402
from ..ops import roi_align_cuda as rc  # noqa: E402
from ..utils import compile_cache  # noqa: E402
from ..utils.warm_start import serving_stems  # noqa: E402

_T_IMPORTS = time.perf_counter()

CONFIG = "kitti_multiclass"
KITTI_K = ((721.5, 0.0, 609.6), (0.0, 721.5, 172.9), (0.0, 0.0, 1.0))
KITTI_HW = (375.0, 1242.0)
STAGES = ("full", "backbone")
INIT_MARK = "init_detector (fast=True)"    # JAX's f"init_detector (fast={fast})"


class Marks:
    """Prints and keeps each mark's seconds since the last and the running
    total; the first, ``imports``, is the module's import."""

    def __init__(self, tag: str, device: torch.device):
        self.tag, self.device = tag, device
        self.rows = []
        self.total = 0.0
        self.last = _T0
        self("imports", _T_IMPORTS)
        self.last = time.perf_counter()

    def __call__(self, label: str, now: Optional[float] = None) -> None:
        """Marks ``label`` at ``now``, else once the device is idle."""
        if now is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
        dt = now - self.last
        self.total += dt
        self.rows.append(dict(mark=label, s=dt, total_s=self.total))
        print(f"[cold {self.tag}] {label:>28}: {dt:9.3f}s (total {self.total:8.3f}s)",
              flush=True)
        self.last = now


@contextlib.contextmanager
def env_set(name: str, value: str):
    """``os.environ[name]`` set to ``value``, restored afterwards."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def device_inputs(cfg, batch: int, device: torch.device):
    """Normalised padded images drawn on the device (seeded), KITTI's K and
    image size."""
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.randn((batch, cfg.data.pad_height, cfg.data.pad_width, 3),
                         generator=gen, device=device)
    cam = torch.tensor(KITTI_K, device=device).expand(batch, 3, 3).contiguous()
    shapes = torch.tensor([KITTI_HW], device=device).expand(batch, 2).contiguous()
    return images, cam, shapes


def request(session: InferenceSession, stage: str, inputs) -> tuple:
    """One request on the session, fetched: (its checksum, the detections
    or None for the backbone stage)."""
    if stage == "backbone":
        with torch.inference_mode():
            feats = session.model.extract_feats(inputs[0])
        return float(sum(f.float().sum() for f in feats)), None
    det = session.run(*inputs, seed=2)
    return float(det.bboxes_3d.float().sum()), det


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Cold-start breakdown of the serving path")
    p.add_argument("batch", nargs="?", type=int, default=8)
    p.add_argument("align_impl", nargs="?", default="auto")
    p.add_argument("stage", nargs="?", default="full", choices=STAGES)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--cache-dir", default=None,
                   help="the builds' root (default: a fresh temporary directory)")
    p.add_argument("--warm", action="store_true",
                   help="build the session with init_inference(warm=True)")
    p.add_argument("--save", default=None,
                   help="torch.save the first request's detections here")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    fresh = args.cache_dir is None
    saved_root = compile_cache._root
    cache_dir = compile_cache.enable_compilation_cache(
        tempfile.mkdtemp(prefix="coldcc_") if fresh else args.cache_dir)
    try:
        with env_set("MONORUN_ALIGN_IMPL", args.align_impl):
            return profile(args, cache_dir)
    finally:
        compile_cache._root = saved_root
        if fresh:
            shutil.rmtree(cache_dir, ignore_errors=True)


def profile(args: argparse.Namespace, cache_dir) -> Dict[str, object]:
    B, stage = args.batch, args.stage
    device = resolve_device(args.device)
    tag = f"{args.align_impl}/{stage}" + ("/warm" if args.warm else "")
    marks = Marks(tag, device)
    jobs0 = len(rc.build_all.built)
    cfg = apply_overrides(get_config(CONFIG), args.cfg_options)
    h, w = cfg.data.pad_height, cfg.data.pad_width
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device).add_(1.0)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={device} ({name}) batch={B} {h}x{w} {cfg.compute_dtype} "
          f"cache={cache_dir}", flush=True)
    marks("backend init")

    out = dict(config=CONFIG, batch=B, align_impl=args.align_impl, stage=stage,
               device=str(device), warm=args.warm, cache_dir=str(cache_dir))
    if args.warm:
        counts = rc.launch_counts()
        session = init_inference(cfg, batch_size=B, device=device, seed=0, warm=True)
        out["warm_launches"] = {k: v - counts[k] for k, v in rc.launch_counts().items()}
        out["warm_seconds"] = session.warm_seconds
        marks("init_inference (warm)")
        for piece, s in (session.warm_seconds or {}).items():
            print(f"[cold {tag}] {'warm_start ' + piece:>28}: {s:9.3f}s", flush=True)
    else:
        model = init_detector(cfg, torch.Generator().manual_seed(0))
        marks(INIT_MARK)
        session = InferenceSession(cfg, model, B, device, warm=False)
        marks("precast")

    inputs = device_inputs(cfg, B, device)
    marks("on-device inputs")

    if not args.warm:
        stems = serving_stems(cfg, B) if device.type == "cuda" and stage == "full" else ()
        if stems:
            rc.build_all(stems)
        out["stems"] = list(stems)
        marks("kernel build")

    counts = rc.launch_counts()
    jobs = len(rc.build_all.built)
    v1, det = request(session, stage, inputs)
    out["first_request_nvcc_jobs"] = len(rc.build_all.built) - jobs
    marks("first request" if args.warm else "first exec+fetch")
    v2, _ = request(session, stage, inputs)
    marks("second request" if args.warm else "second exec+fetch")
    out["launches"] = {k: v - counts[k] for k, v in rc.launch_counts().items()}
    print(f"checksum {v1:.3f} / {v2:.3f}", flush=True)
    out["checksum"] = [v1, v2]
    if args.save and det is not None:
        torch.save({k: v.cpu() for k, v in det._asdict().items() if k != "extras"},
                   args.save)

    host = np.random.default_rng(0).normal(0, 1, (B, h, w, 3)).astype(np.float32)
    marks.last = time.perf_counter()
    up = upload(host, device)
    float(up[0, 0, 0, 0])
    out["upload_mb"] = host.nbytes / 1e6
    marks(f"host upload {host.nbytes / 1e6:.0f}MB")

    out["marks"] = marks.rows
    out["nvcc_jobs"] = rc.build_all.built[jobs0:]
    print("cold_profile " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
