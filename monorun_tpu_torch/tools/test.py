"""Evaluation CLI of the port (the counterpart of ``tools/test.py``).

    python -m monorun_tpu_torch.tools.test kitti_multiclass CKPT.pth \
        --val-set --eval bbox bev 3d --result-dir results/

Runs on the GPU unless ``--device cpu`` is given. Distributed over a
host's N GPUs, one process each (the reference's ``--launcher`` and
``multi_gpu_test``):

    python -m torch.distributed.run --nproc-per-node N \
        -m monorun_tpu_torch.tools.test kitti_multiclass CKPT --val-set --distributed

``--batch-size`` is then the batch over the host's GPUs, as in the JAX
package: each rank serves ``batch_size / N`` images of its strided shard.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, Optional, Sequence

from ..apis.inference import init_inference
from ..apis.test import run_eval
from ..config import apply_overrides, get_config
from ..data.kitti import KITTI3DDataset
from ..parallel import launch_env, process_group, rank
from ..utils.compile_cache import enable_compilation_cache


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate the MonoRUn port")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="reference .pth (optional: random weights for smoke "
                        "runs)")
    p.add_argument("--val-set", action="store_true",
                   help="evaluate the validation split instead of test")
    p.add_argument("--eval", nargs="*", default=["bbox", "bev", "3d"])
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--result-dir", default=None,
                   help="write KITTI submission txt files here")
    p.add_argument("--show-dir", default=None,
                   help="save camera+BEV visualisations here")
    p.add_argument("--show-score-thr", type=float, default=0.3)
    p.add_argument("--summary-file", default=None,
                   help="write the AP dict here as JSON")
    p.add_argument("--criteria", default="R40", choices=["R40", "R11"])
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--distributed", action="store_true",
                   help="one process per GPU under python -m torch.distributed.run; "
                        "each evaluates its shard of the dataset")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    enable_compilation_cache()
    batch_size = args.batch_size
    if args.distributed:
        local_world = int(launch_env()["LOCAL_WORLD_SIZE"])
        if batch_size % local_world:
            raise SystemExit(f"--batch-size {batch_size} must be a multiple of the mesh "
                             f"size {local_world}")
        batch_size //= local_world
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    if args.val_set:
        root, lst, labels = cfg.data.train_root, cfg.data.val_list, True
    else:
        root, lst, labels = cfg.data.test_root, cfg.data.test_list, False
    ds = KITTI3DDataset(root, lst, classes=cfg.data.classes, with_labels=labels)
    with (process_group(device=args.device) if args.distributed
          else contextlib.nullcontext(args.device)) as device:
        session = init_inference(
            cfg, args.checkpoint, batch_size=batch_size,
            explicit_lazy=any(o.startswith("neck.lazy_lower") for o in args.cfg_options),
            device=device,
        )
        ap = run_eval(
            session, ds, batch_size=batch_size, metrics=args.eval,
            result_dir=args.result_dir, show_dir=args.show_dir,
            show_score_thr=args.show_score_thr, distributed=args.distributed,
        )
        lead = rank() == 0          # read while the group exists
    if args.summary_file and ap and lead:
        with open(args.summary_file, "w") as f:
            json.dump(ap, f, indent=2)
    return ap


if __name__ == "__main__":
    main()
