"""On the card: the control (``benchlib/control.py``: the reference in
the program's place, its layers on float8) at each cell's own size fails
the cell's committed limits. Run on the card with

    python -m pytest --noconftest -m cuda benchmark/test_bench_control.py
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import cli, spec  # noqa: E402

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(card, name):
    from benchlib import env

    env.set_caches()
    cell = spec.load_cell(name)
    limits = cli.limits_of(cell)
    seed = 2 ** 31 + 4099
    from benchlib import serve

    run = serve.ServeRun(cell, seed, card)
    answers = run.window(2.0)["answers"]
    run.free_program()
    checks, _ = serve.check(run, answers, len(answers), seed, limits, control="float8")
    assert checks and not all(c["ok"] for c in checks), checks
