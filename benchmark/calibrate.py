"""The readings a cell's limits are set from, in one process:
the program against the reference on each of ``--seeds`` seeds, and the
float8 control against the reference on the first ``--control`` of them.

    python3 benchmark/calibrate.py --workload serve_mc_b8 --seeds 12 \
        --control 3 --seconds 3 --out build/cal_serve_mc_b8.json

Each seed builds the cell anew (weights, scenes, draws), runs a window
of ``--seconds`` and judges its sampled requests as a run does. Prints
one line per seed and reading, then each number's largest program
reading and smallest control reading. It also reads the reference in the
configuration's own dtype in the program's place (side ``stated``) on
the first ``--control`` seeds, for comparison."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import env, serve, spec  # noqa: E402


def seeds(n: int, base: int = 2 ** 31 + 101):
    return [base + 7919 * i for i in range(n)]


def calibrate(cell, n_seeds: int, n_control: int, seconds: float, device="cuda"):
    rows = []
    for i, seed in enumerate(seeds(n_seeds)):
        t0 = time.perf_counter()
        run = serve.ServeRun(cell, seed, device)
        w = run.window(seconds)
        answers = w["answers"]
        run.free_program()
        checks, pick = serve.check(run, answers, len(answers), seed, {})
        rows.append(dict(seed=seed, side="program", requests=len(answers), picked=pick,
                         **{c["name"]: c["value"] for c in checks}))
        sides = ("float8", "stated") if i < n_control else ()
        for side in sides:
            checks, _ = serve.check(run, answers, len(answers), seed, {}, control=side)
            rows.append(dict(seed=seed, side=side, picked=pick,
                             **{c["name"]: c["value"] for c in checks}))
        for r in rows[-1 - len(sides):]:
            print(json.dumps(r), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        del run
    return rows


def summary(rows):
    names = [k for k, v in rows[0].items()
             if k not in ("seed", "side", "requests", "picked") and isinstance(v, (int, float))]
    out = {}
    for k in names:
        prog = [r[k] for r in rows if r["side"] == "program"]
        ctrl = [r[k] for r in rows if r["side"] == "float8"]
        out[k] = dict(program_max=max(prog), control_min=min(ctrl) if ctrl else None,
                      program=prog, control=ctrl)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="readings for a served cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    env.set_caches()
    cell = spec.load_cell(args.workload)
    env.require_cuda(cell.chips)
    rows = calibrate(cell, args.seeds, args.control, args.seconds)
    s = summary(rows)
    for k, v in s.items():
        print(f"{k}: program max {v['program_max']!r}, control min {v['control_min']!r}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=env.card_line(), rows=rows, summary=s), indent=1))


if __name__ == "__main__":
    main()
