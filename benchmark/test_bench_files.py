"""The benchmark's files, its statistics and its checks of the run's
surroundings, on the CPU."""

import json
import math
import re

import numpy as np
import pytest
import torch

from benchlib import cli, env, spec, stats, trace

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads_with_a_reader_for_every_metric(name):
    from monorun_ref.config import MonoRUnConfig as RefConfig
    from monorun_tpu_torch.config import MonoRUnConfig

    cell = spec.load_cell(name)
    assert cell.traffic["kind"] == "serve"
    cfg = spec.build_config(MonoRUnConfig, cell.config["config"])
    ref = spec.build_config(RefConfig, cell.config["config"])
    assert cfg.name == ref.name == cell.config["name"] and cfg.compute_dtype == "bfloat16"
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", sorted({c["name"] for c in BENCH["configs"]}))
def test_configuration_is_the_presets_own(name):
    """A configuration file holds its preset of the program as it is today."""
    import dataclasses

    from monorun_tpu_torch.config import get_config

    cfg = json.loads(json.dumps(dataclasses.asdict(get_config(name))))
    assert spec.load_json(spec.HERE / "configs" / f"{name}.json")["config"] == cfg


def test_module_check_compares_whole_top_level_names():
    names = ["jax.numpy", "jaxlib", "flax.core", "monorun_tpu.ops.pnp", "monorun_tpu",
             "monorun_tpu_torch.ops", "jaxtyping", "numpy", "monorun_ref.models"]
    assert env.forbidden_modules(names) == ["flax.core", "jax.numpy", "jaxlib", "monorun_tpu",
                                            "monorun_tpu.ops.pnp"]


def test_a_run_of_the_harness_loads_no_jax():
    """What a run imports, the harness and the program, loads neither
    JAX nor the JAX package (checked in a fresh interpreter)."""
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [%r, %r]; import benchlib.cli, benchlib.serve, "
            "benchlib.trace, benchlib.flops, benchlib.alignwork, "
            "monorun_tpu_torch.apis.inference, monorun_ref.models.detector; "
            "from benchlib import env; "
            "print(env.forbidden_modules())") % (str(spec.HERE), str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", CELLS[0], "--seed", str(2 ** 31 + 5), "--seconds", "1",
                   "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no result" in out.err


def test_p95_is_over_every_request():
    rng = np.random.default_rng(3)
    xs = rng.exponential(1.0, 401).tolist()
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95), rel=1e-12)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(101)), 95) == 95.0


def test_rates_are_over_the_whole_window():
    assert stats.rate(120, 30.0) == 4.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_idle_union_of_hand_made_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41), (41, 45)]
    assert trace.union_length(iv) == 15 + 10 + 5
    assert trace.merged(iv) == [(0, 15), (20, 30), (40, 45)]
    assert trace.union_length([]) == 0


def test_each_launch_counts_for_the_stage_range_that_holds_it():
    ranges = [(0, 10, "a"), (12, 20, "b")]
    items = [(1, 2.0, "k"), (10, 1.0, "k"), (11, 4.0, "k"), (15, 8.0, "k"), (30, 16.0, "k")]
    us, n = trace.attribute(items, ranges)
    assert us == {"a": 3.0, trace.OUTSIDE: 20.0, "b": 8.0}
    assert n == {"a": 2, trace.OUTSIDE: 2, "b": 1}


def test_mfu_and_roofline_readers():
    from benchlib import readers
    from benchlib.flops import PEAK_BF16

    ctx = cli.Context(window=dict(items=10, window_s=2.0), flops_per_item=PEAK_BF16 / 100)
    assert readers.mfu(ctx) == pytest.approx(5.0)   # 1 % of the peak per item, 5 items/s
    ctx.reduced = trace.Reduced(units=2, window_s=1.0, busy_s=0.25,
                                stage_us={"align_proposals": 400.0})
    ctx.bounds = {"align_proposals": 0.0001}
    assert readers.roofline(ctx, "align_proposals", "align_proposals") == pytest.approx(50.0)
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    assert readers.stage_ms(ctx, ("pnp",)) is None
    assert math.isclose(readers.stage_ms(ctx, ("align_proposals",)), 0.2)


def test_window_is_a_closed_loop_timed_from_each_send():
    """The next batch goes when the last one's answers are back, until
    the window's seconds have passed; each latency is its own request's."""
    import time

    from benchlib import serve

    class Stub(serve.ServeRun):
        def __init__(self):
            self.requests = type("R", (), {"batch": 8})()

        def request(self, i):
            time.sleep(0.05)
            return {}

    w = Stub().window(0.5)
    n = len(w["latency_s"])
    assert 8 <= n <= 11 and all(0.05 <= x < 0.1 for x in w["latency_s"])
    assert w["window_s"] >= 0.5 and w["frames"] == 8 * n
