"""``tests/torch_share.py:run_shared``: one computation per key and test run,
across processes, and a memo outside xdist. What it stores, and
``pack``/``unpack``, are in ``test_torch_share_arrays.py``; each file holds
at most 3 tests, which xdist hands out late.

The cross-process cases start fresh interpreters under a made-up
``PYTEST_XDIST_TESTRUNUID`` and a ``TMPDIR`` of their own; each
computation appends a line to a counter file, so the file says how many
times it ran.
"""

import os
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np

import torch_share
from torch_share import cpu_share, run_shared  # noqa: F401

TESTS = Path(__file__).parent

CHILD = """
import os, sys, time
import numpy as np
from torch_share import run_shared

def compute():
    with open(os.environ["COUNTER"], "a") as f:
        f.write("call\\n")
    if os.environ.get("DIE"):
        os._exit(3)                      # dies holding the lock
    time.sleep(float(os.environ.get("HOLD", "0")))
    return {"x": np.arange(5, dtype=np.float32) * 1.5, "n": (np.int64(7), None)}

out = run_shared("counter test", compute)
print(float(out["x"].sum()), int(out["n"][0]), out["n"][1])
"""


def child(tmp, run, **env):
    """A fresh interpreter running ``CHILD`` under run id ``run``."""
    env = dict(os.environ, PYTHONPATH=str(TESTS), TMPDIR=str(tmp),
               PYTEST_XDIST_TESTRUNUID=run, COUNTER=str(tmp / "counter"), **env)
    return subprocess.Popen([sys.executable, "-c", CHILD], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def calls(tmp):
    path = tmp / "counter"
    return len(path.read_text().splitlines()) if path.exists() else 0


def test_one_computation_across_processes_and_again_for_a_new_run(tmp_path):
    """Two processes of one run ask together: one computes while the other
    waits on the lock, and both print the same result; the last one out
    removes the run's directory. A third process under another run id
    computes again."""
    run = f"fake-{uuid.uuid4().hex}"
    procs = [child(tmp_path, run, HOLD="1.5"), child(tmp_path, run, HOLD="1.5")]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["15.0", "7", "None"]
    assert calls(tmp_path) == 1
    assert not [p for p in os.listdir(tmp_path) if p.startswith("monorun_t1_")]
    out, err = child(tmp_path, f"fake-{uuid.uuid4().hex}").communicate(timeout=120)
    assert out.split() == ["15.0", "7", "None"], err
    assert calls(tmp_path) == 2


def test_a_worker_that_dies_holding_the_lock_releases_it(tmp_path):
    """The next worker of the run computes, and at its exit removes the
    directory the dead one left; a killed run's directory goes when another
    run first uses its own."""
    run = f"fake-{uuid.uuid4().hex}"
    dead = child(tmp_path, run, DIE="1")
    dead.communicate(timeout=120)
    assert dead.returncode == 3 and calls(tmp_path) == 1
    assert os.path.isdir(tmp_path / f"monorun_t1_{run}")
    out, err = child(tmp_path, run).communicate(timeout=120)
    assert out.split() == ["15.0", "7", "None"], err
    assert calls(tmp_path) == 2
    assert not os.path.exists(tmp_path / f"monorun_t1_{run}")
    killed = f"fake-{uuid.uuid4().hex}"
    child(tmp_path, killed, DIE="1").communicate(timeout=120)
    assert os.path.isdir(tmp_path / f"monorun_t1_{killed}")
    child(tmp_path, f"fake-{uuid.uuid4().hex}").communicate(timeout=120)
    assert not os.path.exists(tmp_path / f"monorun_t1_{killed}")
    assert not os.path.exists(tmp_path / f"monorun_t1_{killed}.lock")


def test_outside_xdist_it_memoises(monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_TESTRUNUID", raising=False)
    assert torch_share.shared_dir() is None
    key = f"memo test {uuid.uuid4().hex}"
    made = []

    def compute():
        made.append(1)
        return [np.float32(2.5), {"a": np.ones((2, 3))}]

    first, second = run_shared(key, compute), run_shared(key, compute)
    assert made == [1] and second is first
    assert isinstance(first, list) and first[0].dtype == np.float32
    np.testing.assert_array_equal(first[1]["a"], np.ones((2, 3)))
