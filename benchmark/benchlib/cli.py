"""One run of one cell:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Loads the cell's files, makes the weights and the traffic from the seed,
warms the cell's one shape, measures for ``--seconds``, checks a sample
of what the window produced against the plain reference, and prints one
JSON line last."""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, Optional, Sequence

from . import env, spec


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    setup_s: Optional[float] = None
    window: Optional[Dict[str, Any]] = None      # items, window_s, latency_s
    reduced: Any = None                          # trace.Reduced
    flops_per_item: Optional[float] = None
    bounds: Optional[Dict[str, float]] = None    # s per batch or step


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(cell: spec.Cell, ctx: Context, traced: bool) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def limits_of(cell: spec.Cell) -> Dict[str, float]:
    path = spec.HERE / "limits" / f"{cell.name}.json"
    return spec.load_json(path)["limits"] if path.exists() else {}


def main(argv: Sequence[str], t0: float, device: str = "cuda",
         cell: Optional[spec.Cell] = None) -> int:
    args = parse_args(argv)
    env.set_caches()
    cell = cell or spec.load_cell(args.workload)
    if device == "cuda":
        try:
            env.require_cuda(cell.chips)
        except env.NoDevice as e:
            print(e, file=sys.stderr)
            return 2
    kind = cell.traffic["kind"]
    if kind != "serve":
        raise ValueError(f"unknown traffic kind {kind!r}")
    from .serve import run_cell
    result, checks = run_cell(cell, args, t0, device, limits_of(cell))
    bad = env.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}: no result", file=sys.stderr)
        return 3
    env.emit(result, checks)
    return 0
