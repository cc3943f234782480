"""Run inference on a directory of images (the counterpart of
``demo/infer_imgs.py``).

    python -m monorun_tpu_torch.demo.infer_imgs IMG_DIR kitti_multiclass CKPT.pth \
        --calib demo/calib.csv --show-dir viz/

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import cv2

from ..apis.inference import inference_detector, init_inference, read_calib_csv
from ..utils.visualizer import show_result


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(description="MonoRUn port: detect on image files")
    p.add_argument("img_dir")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--calib", required=True,
                   help="csv with the 3x3 camera intrinsic matrix")
    p.add_argument("--calib-scale", type=float, default=1.0)
    p.add_argument("--show-dir", default="viz")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)

    cam = read_calib_csv(args.calib)
    if args.calib_scale != 1.0:
        cam = cam.copy()
        cam[:2] *= args.calib_scale

    paths = sorted(
        sum((glob.glob(os.path.join(args.img_dir, e))
             for e in ("*.png", "*.jpg", "*.jpeg")), [])
    )
    if not paths:
        raise SystemExit(f"no images found in {args.img_dir}")
    session = init_inference(args.config, args.checkpoint, device=args.device)
    os.makedirs(args.show_dir, exist_ok=True)

    results = inference_detector(session, paths, [cam] * len(paths))
    for path, res in zip(paths, results):
        show_result(
            cv2.imread(path), res, cam,
            out_file=os.path.join(args.show_dir, os.path.basename(path)),
            score_thr=args.score_thr,
        )
        print(f"{os.path.basename(path)}: {int(res['valid'].sum())} detections")
    return results


if __name__ == "__main__":
    main()
