"""The data-parallel CLIs on two CPU processes over Gloo:
``tools.train --distributed`` and ``tools.test --distributed`` under
``python -m torch.distributed.run --nproc-per-node 2`` with ``--device
cpu``; ``tools.test`` refuses a batch that does not divide over the ranks,
and both refuse ``--distributed`` without the launch environment.

Part (d) of ``tests/test_torch_parallel.py``'s plan, in a file of its own
of at most 5 tests, so that xdist hands it out after
``tests/test_train_step.py`` (ROADMAP's test-time budget).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import make_mini_kitti
from monorun_tpu_torch import parallel

from test_torch_eval_path import TINY_OPTIONS
from test_torch_parallel import EVAL_IMAGES, REPO, TIMEOUT, WORLD, child_env, free_port
from test_torch_train_cli import TINY_OPTIONS as TRAIN_OPTIONS
from test_torch_train_loop import write_small_kitti
from torch_share import cpu_share  # noqa: F401


def torchrun(module, args, cwd, timeout=TIMEOUT):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(WORLD),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()), "-m", module,
           *args]
    env = child_env()
    env["OMP_NUM_THREADS"] = str(max(1, torch.get_num_threads() // WORLD))
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out


def test_tools_train_distributed_two_ranks(tmp_path):
    """Two CPU ranks over Gloo, a global batch of 4 (2 per rank), an epoch
    of 2 steps with a checkpoint, a validation and a log record a step:
    rank 0 alone writes the log and the checkpoint."""
    root, work = tmp_path / "kitti", tmp_path / "work"
    write_small_kitti(str(root), 8)
    opts = [f"data.train_root='{root}'", "data.train_list='train_list.txt'",
            "data.val_list='train_list.txt'", *TRAIN_OPTIONS, "train.total_epochs=1"]
    out = torchrun("monorun_tpu_torch.tools.train",
                   ["kitti_multiclass_lidar_supv", "--device", "cpu", "--distributed",
                    "--work-dir", str(work), "--max-steps", "2", "--cfg-options", *opts], REPO)
    log = [json.loads(ln) for ln in (work / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2], log   # 8 images: 2 global batches of 4
    assert all(np.isfinite(v) for r in log for v in r.values())
    assert sorted(os.listdir(work)) == ["config.txt", "step_2", "train_log.jsonl"]
    assert os.listdir(work / "step_2") == ["checkpoint.pt"]
    assert out.stdout.count("[e0 it2]") == 1, out.stdout    # one rank logged
    shutil.rmtree(work)


def test_tools_test_distributed_two_ranks(tmp_path):
    root = tmp_path / "kitti"
    make_mini_kitti(str(root), n_images=EVAL_IMAGES, seed=1)
    summary, results = tmp_path / "ap.json", tmp_path / "results"
    torchrun("monorun_tpu_torch.tools.test",
             ["kitti_multiclass", "--val-set", "--device", "cpu", "--distributed",
              "--batch-size", "4", "--summary-file", str(summary), "--result-dir",
              str(results), "--cfg-options", f"data.train_root='{root}'",
              "data.val_list='train_list.txt'", *TINY_OPTIONS], REPO)
    ap = json.loads(summary.read_text())
    assert ap and all(np.isfinite(v) for v in ap.values())
    assert len(os.listdir(results)) == EVAL_IMAGES


def test_tools_test_refuses_a_batch_that_does_not_divide(monkeypatch):
    from monorun_tpu_torch.tools import test as tools_test

    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="--batch-size 3 must be a multiple of the mesh "
                                         "size 2"):
        tools_test.main(["kitti_multiclass", "--device", "cpu", "--distributed",
                         "--batch-size", "3"])
    assert parallel.world_size() == 1


@pytest.mark.parametrize("tool", ["train", "test"])
def test_distributed_without_the_launch_environment_raises(monkeypatch, tool):
    import importlib

    for k in parallel.mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    main = importlib.import_module(f"monorun_tpu_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        main(["kitti_multiclass", "--device", "cpu", "--distributed"])
