"""The data-parallel CLIs on two CPU processes over Gloo:
``tools.train --distributed`` and ``tools.test --distributed`` under
``python -m torch.distributed.run --nproc-per-node 2`` with ``--device
cpu``; ``tools.test`` refuses a batch that does not divide over the ranks,
and both refuse ``--distributed`` without the launch environment.

Part (d) of ``tests/test_torch_parallel.py``'s plan, in files of at most 3
tests, which xdist hands out late (ROADMAP's test-time budget): the two
launches are in ``test_torch_parallel_cli_launch.py``.
"""

import subprocess
import sys

import pytest
import torch

from monorun_tpu_torch import parallel

from test_torch_parallel import TIMEOUT, WORLD, child_env, free_port
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
