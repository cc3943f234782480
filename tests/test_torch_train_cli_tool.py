"""``tests/test_torch_train_cli.py``'s ``tools.train`` command line, in a file
of at most 3 tests (xdist hands it out late); that file states the cases and
the tolerances.
"""

import os
import subprocess
import sys

import pytest
import torch

from monorun_tpu_torch.apis import train as tapi
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.tools import train as ttools

from torch_share import cpu_share  # noqa: F401


def test_tools_train_cli():
    out = subprocess.run([sys.executable, "-m", "monorun_tpu_torch.tools.train", "--help"],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0
    for flag in ("--work-dir", "--resume-from", "--load-from", "--seed", "--max-steps",
                 "--no-validate", "--cfg-options", "--device", "--distributed"):
        assert flag in out.stdout, flag
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        ttools.main(["kitti_multiclass", "--distributed"])    # not launched by torchrun
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.train_detector(tget_config("kitti_multiclass"), "unused")
