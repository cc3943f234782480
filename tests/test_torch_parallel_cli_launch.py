"""``tests/test_torch_parallel_cli.py``'s two launches under
``torch.distributed.run``, in a file of at most 3 tests (xdist hands it out
late); that file states the cases and the tolerances.
"""

import json
import os
import shutil

import numpy as np

from fixtures import make_mini_kitti
from test_torch_eval_path import TINY_OPTIONS
from test_torch_parallel import EVAL_IMAGES, REPO
from test_torch_parallel_cli import torchrun
from test_torch_train_cli import TINY_OPTIONS as TRAIN_OPTIONS
from test_torch_train_loop import write_small_kitti
from torch_share import cpu_share  # noqa: F401


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
