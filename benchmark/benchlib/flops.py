"""Model FLOPs per item, counted by ``torch.utils.flop_counter.
FlopCounterMode`` (matrix products and convolutions, 2 per multiply-add)
over the frozen reference at the cell's exact configuration, never over
the program, and kept in ``build/flops/`` by the configuration and the
shapes, so a configuration is counted once per checkout."""

from __future__ import annotations

import hashlib
import json
from typing import Callable

from .env import BUILD

# NVIDIA H100 SXM data sheet: dense bfloat16 tensor-core FLOP/s at 700 W
PEAK_BF16 = 989e12


def cached(key_parts, count: Callable[[], float]) -> float:
    key = hashlib.sha1(json.dumps(key_parts, sort_keys=True).encode()).hexdigest()[:16]
    path = BUILD / "flops" / f"{key}.json"
    if path.exists():
        return json.loads(path.read_text())["flops"]
    value = float(count())
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(flops=value)))
    return value


def counted(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()
