"""Training CLI of the port (the counterpart of ``tools/train.py``).

    python -m monorun_tpu_torch.tools.train kitti_multiclass_lidar_supv \
        --work-dir work_dirs/lidar_supv \
        --cfg-options train.lr=1e-4 data.train_root=/data/kitti/training/

Runs on the GPU unless ``--device cpu`` is given. Writes ``config.txt``,
``train_log.jsonl`` and the ``step_N`` checkpoints into the work dir, and
validates on ``data.val_list`` every ``train.eval_interval`` epochs unless
``--no-validate``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..apis.train import train_detector
from ..config import apply_overrides, get_config
from ..data.kitti import KITTI3DDataset


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the MonoRUn port")
    p.add_argument("config", help="preset name (e.g. kitti_multiclass)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None,
                   help="warm-start weights (.pth or a step_N checkpoint directory)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="not yet: comes with the port's multi-GPU slice")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Returns ``train_detector``'s (model, final train state)."""
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed comes with the port's multi-GPU slice (torch.distributed)"
        )
    cfg = get_config(args.config)
    if args.seed is not None:
        cfg = apply_overrides(cfg, [f"train.seed={args.seed}"])
    cfg = apply_overrides(cfg, args.cfg_options)

    workdir = args.work_dir or os.path.join("work_dirs", cfg.name)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.txt"), "w") as f:
        f.write(repr(cfg))

    val_ds = None
    if not args.no_validate and cfg.train.eval_interval:
        val_ds = KITTI3DDataset(cfg.data.train_root, cfg.data.val_list,
                                classes=cfg.data.classes)
    return train_detector(cfg, workdir, resume_from=args.resume_from,
                          load_from=args.load_from, max_steps=args.max_steps,
                          val_ds=val_ds, device=args.device)


if __name__ == "__main__":
    main()
