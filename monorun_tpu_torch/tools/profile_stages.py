"""Stage ladder of the port's serving forward (the counterpart of
``tools/profile_stages.py``).

    python -m monorun_tpu_torch.tools.profile_stages [batch] \
        [--cfg-options ...] [--device cpu]

Serves kitti_multiclass at full width with seeded random weights through
``init_inference(raw=True)`` -> ``InferenceSession.run`` on random uint8
canvases holding 375x1242 images, and times each stage of the real
forward in place (``utils/stages.py``: preprocess, backbone_fpn,
rpn_proposals, align_proposals, bbox_head_nms, global_head_mc, noc_head,
pnp, score_3d_nms). At every stage boundary the host waits for the card,
so a stage's ms is its wall time alone, and its launches are the counts
of the port's hand-written kernels (``ops/roi_align_cuda.py``). Each
figure is the median over ``FORWARDS`` forwards after ``WARMUP``. Every
timed forward is paired with an unsplit one (no boundary waits), whose
median is printed beside the stages' sum: the boundaries' cost. The
card's busy time per stage is ``profile_trace``'s.

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..apis.inference import InferenceSession, init_inference
from ..config import MonoRUnConfig, apply_overrides, get_config
from ..ops import roi_align_cuda as rc
from ..utils.compile_cache import enable_compilation_cache
from ..utils.stages import STAGES, timing

CONFIG = "kitti_multiclass"
FORWARDS, WARMUP = 5, 2
KITTI_K = ((721.5377, 0.0, 609.5593), (0.0, 721.5377, 172.854), (0.0, 0.0, 1.0))
KITTI_HW = (375, 1242)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def canvases(cfg: MonoRUnConfig, batch: int, n: int, device: torch.device,
             seed: int = 1) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``n`` requests of ``batch`` random uint8 canvases on ``device``, each
    holding a KITTI-sized image (cut to the canvas) with KITTI's K."""
    gen = torch.Generator(device=device).manual_seed(seed)
    H, W = cfg.data.raw_height, cfg.data.raw_width
    hw = [float(min(KITTI_HW[0], H)), float(min(KITTI_HW[1], W))]
    cam = torch.tensor(KITTI_K, device=device).expand(batch, 3, 3).contiguous()
    shapes = torch.tensor([hw], device=device).expand(batch, 2).contiguous()
    return [(torch.randint(0, 256, (batch, H, W, 3), generator=gen, device=device,
                           dtype=torch.uint8), cam, shapes) for _ in range(n)]


def serving_session(cfg: MonoRUnConfig, batch: int, device: str | torch.device
                    ) -> InferenceSession:
    """The session the tools profile: seeded random weights, canvas input."""
    return init_inference(cfg, batch_size=batch, device=device, seed=0, raw=True)


class StageTimer:
    """A ``utils.stages.timing`` hook: each stage's ms between synchronised
    boundaries and its launches of the hand-written kernels, appended to
    ``records`` in run order."""

    def __init__(self, device: torch.device):
        self.device = device
        self.records: List[dict] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        synchronize(self.device)
        before = rc.launch_counts()
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        after = rc.launch_counts()
        self.records.append(dict(
            stage=name, ms=ms,
            launches={k: v - before[k] for k, v in after.items() if v != before[k]}))


def timed_run(session: InferenceSession, request, seed: int = 0) -> float:
    """Host ms of one synchronised ``session.run``."""
    synchronize(session.device)
    t0 = time.perf_counter()
    session.run(*request, seed=seed)
    synchronize(session.device)
    return (time.perf_counter() - t0) * 1e3


def ladder(session: InferenceSession, requests, forwards: int = FORWARDS,
           warmup: int = WARMUP) -> dict:
    """The stage ladder over ``forwards`` forwards after ``warmup``: per
    stage the median ms and the launches of the first timed forward
    (``stages``, in run order); the unsplit forward's median ms and the
    stages' summed ms (``unsplit_ms``, ``stage_sum_ms``); every forward's
    stage records (``forward_records``)."""
    for i in range(warmup):
        session.run(*requests[i % len(requests)], seed=i)
    unsplit, runs = [], []
    for i in range(forwards):
        req = requests[i % len(requests)]
        unsplit.append(timed_run(session, req, seed=i))
        timer = StageTimer(session.device)
        with timing(session.model, timer):
            session.run(*req, seed=i)
        synchronize(session.device)
        runs.append(timer.records)
    names = [r["stage"] for r in runs[0]]
    stages = []
    for j, name in enumerate(names):
        recs = [run[j] for run in runs]
        stages.append(dict(stage=name, ms=statistics.median(r["ms"] for r in recs),
                           launches=recs[0]["launches"]))
    return dict(batch=session.batch_size, forwards=forwards, warmup=warmup, stages=stages,
                unsplit_ms=statistics.median(unsplit), unsplit_ms_each=unsplit,
                stage_sum_ms=sum(s["ms"] for s in stages), forward_records=runs)


def print_ladder(result: dict) -> None:
    print(f"stage ladder: batch {result['batch']}, median of {result['forwards']} forwards "
          f"after {result['warmup']}")
    print(f"{'stage':>16} {'ms':>10}  launches")
    for s in result["stages"]:
        launches = ", ".join(f"{k} {v}" for k, v in s["launches"].items()) or "-"
        print(f"{s['stage']:>16} {s['ms']:10.3f}  {launches}")
    share = result["stage_sum_ms"] / result["unsplit_ms"]
    print(f"{'sum of stages':>16} {result['stage_sum_ms']:10.3f}   unsplit forward "
          f"{result['unsplit_ms']:.3f} ms ({share:.3f}x)")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Stage ladder of the serving forward")
    p.add_argument("batch", nargs="?", type=int, default=4)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    enable_compilation_cache()
    cfg = apply_overrides(get_config(CONFIG), args.cfg_options)
    session = serving_session(cfg, args.batch, args.device)
    requests = canvases(cfg, args.batch, 2, session.device)
    result = ladder(session, requests)
    ran = [s["stage"] for s in result["stages"]]
    if ran != list(STAGES):
        raise RuntimeError(f"the forward ran the stages {ran}, not {list(STAGES)}")
    print(f"{CONFIG} batch {args.batch} {cfg.data.pad_height}x{cfg.data.pad_width} "
          f"{cfg.compute_dtype} on {session.device}")
    print_ladder(result)
    return result


if __name__ == "__main__":
    main()
