"""The window's statistics: a tail over every request, rates over the
window's whole time."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(items: float, seconds: float) -> float:
    """Items over the window's whole time."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return items / seconds

