"""What the per-metric readers (``metrics/<name>.py``) share. A reader
takes the run's context and returns a number, or None where the run has
nothing for it to read."""

from __future__ import annotations

from typing import Optional, Sequence

from .flops import PEAK_BF16
from .stats import percentile, rate


def stage_ms(ctx, stages: Sequence[str]) -> Optional[float]:
    """Device ms per batch or step in the program's stages ``stages``;
    None when the trace holds none of them (a stage renamed)."""
    r = ctx.reduced
    if r is None or not any(s in r.stage_us for s in stages):
        return None
    return r.per_unit_ms(stages)


def stage_launches(ctx, stage: str) -> Optional[float]:
    r = ctx.reduced
    if r is None or stage not in r.stage_launches:
        return None
    return r.stage_launches[stage] / r.units


def idle_share(ctx) -> Optional[float]:
    r = ctx.reduced
    if r is None or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def mfu(ctx) -> Optional[float]:
    """Model FLOPs per item x items over the untraced window's whole
    time, as a share of the dense bfloat16 peak: the whole step's."""
    rate_ = items_per_s(ctx)
    if ctx.flops_per_item is None or rate_ is None:
        return None
    return 100.0 * ctx.flops_per_item * rate_ / PEAK_BF16


def items_per_s(ctx) -> Optional[float]:
    """Items over the untraced window's whole time."""
    if ctx.window is None:
        return None
    return rate(ctx.window["items"], ctx.window["window_s"])


def latency_p95_ms(ctx) -> Optional[float]:
    if ctx.window is None or not ctx.window.get("latency_s"):
        return None
    return 1e3 * percentile(ctx.window["latency_s"], 95)


def roofline(ctx, stage: str, key: str) -> Optional[float]:
    """The least time the chip could take for the stage's align calls
    (``ctx.bounds[key]``, s per batch or step) over their device time."""
    ms = stage_ms(ctx, (stage,))
    bound = (ctx.bounds or {}).get(key)
    if ms is None or not ms or bound is None:
        return None
    return 100.0 * bound * 1e3 / ms
