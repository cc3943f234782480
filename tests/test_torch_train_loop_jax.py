"""``tests/test_torch_train_loop.py``'s loop control flow against JAX's
``train_detector``, in a file of at most 3 tests (xdist hands it out late);
that file states the cases and the tolerances.
"""

import os

import numpy as np

from monorun_tpu.apis import train as japi
from monorun_tpu.config import get_config
from monorun_tpu_torch.apis import train as tapi
from monorun_tpu_torch.config import get_config as tget_config

from test_torch_train_loop import (  # noqa: F401
    Recorder, _read_jsonl, _steps_dirs, loop_config, small_kitti, stub_jax, stub_torch,
)
from torch_share import cpu_share  # noqa: F401


def test_loop_control_flow_matches_jax(small_kitti, tmp_path, monkeypatch):  # noqa: F811
    root = small_kitti
    jrec, trec = Recorder(), Recorder()
    stub_jax(monkeypatch, jrec)
    stub_torch(monkeypatch, trec)
    jcfg, tcfg = loop_config(get_config, root), loop_config(tget_config, root)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    runs = []
    # a run cut at 8 steps, then a second call that resumes from the newest
    # step_N of its work dir and runs on to the configured 3 epochs
    for max_steps in (8, None):
        jn, tn = len(jrec.steps), len(trec.steps)
        val_ds = object()
        japi.train_detector(jcfg, jdir, max_steps=max_steps, val_ds=val_ds)
        tapi.train_detector(tcfg, tdir, max_steps=max_steps, val_ds=val_ds, device="cpu")
        runs.append((jn, tn))
        assert jrec.total_steps == trec.total_steps == (8 if max_steps else 9)

    assert len(jrec.steps) == len(trec.steps)
    for j, t in zip(jrec.steps, trec.steps):
        assert j["step"] == t["step"] and j["calib"] == t["calib"]
        assert set(j["batch"]) == set(t["batch"])
        for k in j["batch"]:
            np.testing.assert_array_equal(t["batch"][k], j["batch"][k], err_msg=k)
    steps = [s["step"] for s in trec.steps]
    # 8 steps, then the resume from step_8 runs a whole epoch of 3 (the loop
    # only ends at an epoch's end), to step 11
    assert steps == list(range(8)) + [8, 9, 10]
    assert [s["calib"] for s in trec.steps] == [0.0] * 4 + [0.01] * 7
    assert jrec.vals == trec.vals == [3, 6, 8, 11]
    assert _steps_dirs(jdir) == _steps_dirs(tdir) == ["step_11", "step_6", "step_8"]
    jlog, tlog = (_read_jsonl(os.path.join(d, "train_log.jsonl")) for d in (jdir, tdir))
    assert tlog == jlog
    assert [(r["step"], r["epoch"]) for r in tlog] == [(2, 0), (4, 1), (6, 1), (8, 2),
                                                      (10, 2)]
    # the metrics in sorted key order, as JAX's jitted step returns its dict
    # (here its stub keeps the order it was written in)
    assert list(tlog[0]) == sorted(set(jlog[0]) - {"step", "epoch"}) + ["step", "epoch"]
    jstats, tstats = (_read_jsonl(os.path.join(d, "grad_stats.jsonl")) for d in (jdir, tdir))
    assert tstats == jstats and [r["step"] for r in tstats] == [3, 6, 9]
    # the resume restarts the data order and the augmentation draws at
    # epoch 0 (a flaw of the JAX loop, kept): its batches are the first run's
    for first, resumed in zip(trec.steps[:3], trec.steps[8:]):
        for k in first["batch"]:
            np.testing.assert_array_equal(resumed["batch"][k], first["batch"][k])
