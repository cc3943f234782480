"""Evaluation CLI of the port (the counterpart of ``tools/test.py``).

    python -m monorun_tpu_torch.tools.test kitti_multiclass CKPT.pth \
        --val-set --eval bbox bev 3d --result-dir results/

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from ..apis.inference import init_inference
from ..apis.test import run_eval
from ..config import apply_overrides, get_config
from ..data.kitti import KITTI3DDataset


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
                   help="not yet: comes with the port's multi-GPU slice")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed comes with the port's multi-GPU slice "
            "(torch.distributed)"
        )
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    if args.val_set:
        root, lst, labels = cfg.data.train_root, cfg.data.val_list, True
    else:
        root, lst, labels = cfg.data.test_root, cfg.data.test_list, False
    ds = KITTI3DDataset(root, lst, classes=cfg.data.classes, with_labels=labels)
    session = init_inference(
        cfg, args.checkpoint, batch_size=args.batch_size,
        explicit_lazy=any(o.startswith("neck.lazy_lower") for o in args.cfg_options),
        device=args.device,
    )
    ap = run_eval(
        session, ds, batch_size=args.batch_size, metrics=args.eval,
        result_dir=args.result_dir, show_dir=args.show_dir,
        show_score_thr=args.show_score_thr,
    )
    if args.summary_file and ap:
        with open(args.summary_file, "w") as f:
            json.dump(ap, f, indent=2)
    return ap


if __name__ == "__main__":
    main()
