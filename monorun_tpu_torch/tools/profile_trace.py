"""A ``torch.profiler`` trace of the port's serving forward, by op and by
stage (the counterpart of ``tools/profile_trace.py``).

    python -m monorun_tpu_torch.tools.profile_trace [batch] [top_n] \
        [--profile FILE] [--cfg-options ...] [--device cpu]

Serves kitti_multiclass at full width (batch 8 by default) with seeded random
weights on random canvases, as ``profile_stages`` does, traces 3 forwards
with every stage of ``utils/stages.py`` marked as a ``record_function``
range, and prints:

- the device ms per forward (every kernel, copy and fill on the card);
- the ``top_n`` kernels (40 by default) by device time, with their share
  and launches per forward;
- device ms and launches per stage: each kernel counts for the stage
  whose range its launch fell in on the host (the counterpart of the JAX
  tool's "by framework-op group" table), and the rest on one line;
- the unprofiled ms per batch (median of 5 synchronised forwards) and
  the device's idle share of it.

``--profile FILE`` writes the profiler's whole table. On the CPU
(``--device cpu``) the ops' self CPU time stands where the device time
does.
"""

from __future__ import annotations

import argparse
import collections
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..config import apply_overrides, get_config
from ..utils.stages import STAGES, timing
from .profile_stages import CONFIG, canvases, serving_session, synchronize, timed_run

FORWARDS = 3
OUTSIDE = "(outside the stages)"


def _work_items(events, cuda: bool):
    """(host start us, us, name) of every piece of device work: each kernel
    (or copy, fill) at the host time of the op or range that launched it.
    On the CPU, every op's self time at its start."""
    items = []
    for e in events:
        if e.device_type != DeviceType.CPU or e.is_async:
            continue
        if cuda:
            items.extend((e.time_range.start, k.duration, k.name) for k in e.kernels)
        elif not e.is_user_annotation:
            items.append((e.time_range.start, e.self_cpu_time_total, e.name))
    return items


def trace_forwards(session, requests, forwards: int = FORWARDS, top_n: int = 40,
                   table: Optional[Path] = None) -> dict:
    """Profiles ``forwards`` forwards of ``session`` on ``requests`` (after
    one warm-up) and breaks their device time down by kernel and by stage,
    per forward; with the unprofiled ms per batch and the idle share."""
    dev = session.device
    cuda = dev.type == "cuda"
    session.run(*requests[0])
    unprofiled = statistics.median(timed_run(session, requests[i % len(requests)], seed=i)
                                   for i in range(5))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof, timing(session.model, record_function):
        for i in range(forwards):
            session.run(*requests[i % len(requests)], seed=i)
        synchronize(dev)
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CPU and e.name in STAGES)
    items = _work_items(events, cuda)
    per_stage: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for start, us, name in items:
        # the innermost range holding the launch: stages do not nest, so the
        # last one that starts before it
        stage = OUTSIDE
        for r0, r1, sname in ranges:
            if r0 > start:
                break
            if start <= r1:
                stage = sname
        per_stage[stage][0] += us
        per_stage[stage][1] += 1
        by_name[name][0] += us
        by_name[name][1] += 1
    if cuda:
        # device work no host op or range claims (none is expected) counts
        # outside the stages
        traced = sum(e.time_range.elapsed_us() for e in events
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        per_stage[OUTSIDE][0] += max(traced - sum(v[0] for v in per_stage.values()), 0.0)
    total = sum(v[0] for v in per_stage.values()) / 1e3 / forwards
    stages = [dict(stage=s, ms=per_stage[s][0] / 1e3 / forwards,
                   launches=per_stage[s][1] / forwards) for s in (*STAGES, OUTSIDE)]
    for s in stages:
        s["share"] = s["ms"] / total if total else 0.0
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:top_n]
    if table is not None:
        table.parent.mkdir(parents=True, exist_ok=True)
        key = "self_device_time_total" if cuda else "self_cpu_time_total"
        table.write_text(prof.key_averages().table(sort_by=key, row_limit=-1))
    return dict(
        batch=session.batch_size, forwards=forwards, device=str(dev),
        ms_per_forward=total, launches_per_forward=len(items) / forwards,
        stages=stages, stage_ranges=len(ranges),
        covered_share=1.0 - (stages[-1]["share"]),
        top=[dict(name=n, ms=v[0] / 1e3 / forwards, share=v[0] / 1e3 / forwards / total,
                  launches=v[1] / forwards) for n, v in top],
        unprofiled_ms=unprofiled, idle_share=1.0 - total / unprofiled if cuda else None)


def print_trace(result: dict) -> None:
    what = "device" if result["idle_share"] is not None else "op self CPU"
    print(f"{what} time: {result['ms_per_forward']:.3f} ms per forward over "
          f"{result['forwards']} forwards at batch {result['batch']}, "
          f"{result['launches_per_forward']:.1f} launches per forward")
    for t in result["top"]:
        print(f"{t['ms']:9.3f} ms {100 * t['share']:5.1f}% {t['launches']:8.1f}x  "
              f"{t['name'][:90]}")
    print(f"\nby stage ({what} ms per forward, launches):")
    for s in result["stages"]:
        print(f"{s['stage']:>22} {s['ms']:9.3f} {100 * s['share']:5.1f}% {s['launches']:8.1f}")
    line = f"unprofiled {result['unprofiled_ms']:.3f} ms per batch"
    if result["idle_share"] is not None:
        line += f", the device idle {100 * result['idle_share']:.1f}% of it"
    print(line)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Profiler trace of the serving forward")
    p.add_argument("batch", nargs="?", type=int, default=8)
    p.add_argument("top_n", nargs="?", type=int, default=40)
    p.add_argument("--profile", type=Path, metavar="FILE",
                   help="write the profiler's whole table to FILE")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    cfg = apply_overrides(get_config(CONFIG), args.cfg_options)
    session = serving_session(cfg, args.batch, args.device)
    result = trace_forwards(session, canvases(cfg, args.batch, 2, session.device),
                            top_n=args.top_n, table=args.profile)
    print(f"{CONFIG} batch {args.batch} {cfg.data.pad_height}x{cfg.data.pad_width} "
          f"{cfg.compute_dtype} on {session.device}")
    print_trace(result)
    return result


if __name__ == "__main__":
    main()
