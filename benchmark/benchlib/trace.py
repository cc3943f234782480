"""Reduction of one ``torch.profiler`` window to the per-layer numbers.

Each piece of device work (a kernel, a copy, a fill) is attributed to the
host op that launched it, at that op's start, and so to the program's
stage range that held the launch: the arithmetic of the program's
``tools/profile_trace.py:_work_items``, frozen here. The device's busy
time is the union of its work intervals over the window."""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

OUTSIDE = "(outside the stages)"


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The intervals' union as disjoint intervals, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the intervals (overlaps counted once)."""
    return sum(b - a for a, b in merged(intervals))


@dataclass
class Reduced:
    """Per-window sums: device us and launches by stage and by kernel
    name, the busy union, the window's wall and its units of work."""

    units: int                               # batches or steps traced
    window_s: float
    busy_s: float
    stage_us: Dict[str, float] = field(default_factory=dict)
    stage_launches: Dict[str, int] = field(default_factory=dict)
    name_us: Dict[str, float] = field(default_factory=dict)
    launches: int = 0
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def per_unit_ms(self, stages: Sequence[str]) -> float:
        return sum(self.stage_us.get(s, 0.0) for s in stages) / 1e3 / self.units

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.name_us.items(), key=lambda kv: kv[1], reverse=True)[:10]
        return dict(device_ops=[[n, us / 1e6] for n, us in ops],
                    idle_gaps=[[n, s] for n, s in self.idle_gaps[:10]])


def work_items(events) -> List[Tuple[float, float, str]]:
    """(host start us, us, name) of every piece of device work, at the host
    time of the op or range that launched it."""
    from torch.autograd import DeviceType

    items = []
    for e in events:
        if e.device_type != DeviceType.CPU or e.is_async:
            continue
        items.extend((e.time_range.start, k.duration, k.name) for k in e.kernels)
    return items


def attribute(items, ranges) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Each item's us and launch counted for the last stage range that
    starts at or before its launch and holds it (stages do not nest)."""
    starts = [r[0] for r in ranges]
    us: Dict[str, float] = collections.defaultdict(float)
    n: Dict[str, int] = collections.defaultdict(int)
    for start, dur, _ in items:
        i = bisect.bisect_right(starts, start) - 1
        stage = ranges[i][2] if i >= 0 and start <= ranges[i][1] else OUTSIDE
        us[stage] += dur
        n[stage] += 1
    return dict(us), dict(n)


def reduce_profile(prof, stage_names: Sequence[str], units: int, window_s: float) -> Reduced:
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CPU and e.name in stage_names)
    items = work_items(events)
    stage_us, stage_n = attribute(items, ranges)
    name_us: Dict[str, float] = collections.defaultdict(float)
    for _, dur, name in items:
        name_us[name] += dur
    device = merged((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    busy_us = union_length(device)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and not e.is_async)
    return Reduced(units=units, window_s=window_s, busy_s=busy_us / 1e6,
                   stage_us=stage_us, stage_launches=stage_n, name_us=dict(name_us),
                   launches=len(items), idle_gaps=name_gaps(device, host, ranges))


def name_gaps(busy, host, ranges, top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest gaps between device work, each named by the
    stage range and the innermost host op running at the gap's start."""
    stages = {r[2] for r in ranges}
    gaps = sorted(((b0 - a1, a1) for (_, a1), (b0, _) in zip(busy, busy[1:])), reverse=True)
    out = []
    for length, t in gaps[:top]:
        stage = next((n for a, b, n in reversed(ranges) if a <= t <= b), OUTSIDE)
        op = "(no host op)"
        for a, b, n in host:
            if a > t:
                break
            if b >= t and n not in stages:
                op = n
        out.append((f"{stage} / {op}", length / 1e6))
    return out
