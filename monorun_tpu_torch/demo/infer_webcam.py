"""Live webcam inference (the counterpart of ``demo/infer_webcam.py``).

    python -m monorun_tpu_torch.demo.infer_webcam kitti_multiclass CKPT.pth \
        --calib demo/calib.csv

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import cv2
import numpy as np

from ..apis.inference import detections_to_host, init_inference, read_calib_csv
from ..data.pipeline import normalize_pad
from ..utils.compile_cache import enable_compilation_cache
from ..utils.visualizer import show_result


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="MonoRUn port: detect on a webcam stream")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--calib", required=True)
    p.add_argument("--camera-id", type=int, default=0)
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    enable_compilation_cache()

    cam = read_calib_csv(args.calib)
    session = init_inference(args.config, args.checkpoint, device=args.device)
    cfg = session.cfg

    cap = cv2.VideoCapture(args.camera_id)
    if not cap.isOpened():
        raise SystemExit(f"cannot open camera {args.camera_id}")
    print("press q to quit")
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        t0 = time.time()
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32)
        rgb = rgb[: cfg.data.pad_height, : cfg.data.pad_width]
        padded, (rh, rw) = normalize_pad(rgb, cfg.data)
        det, _ = detections_to_host(session.run(
            padded[None], cam[None].astype(np.float32),
            np.asarray([[float(rh), float(rw)]], np.float32),
        ))
        res = {k: det[k][0] for k in ("bboxes_2d", "labels", "bboxes_3d", "valid",
                                      "pose_cov")}
        out = show_result(frame, res, cam, score_thr=args.score_thr)
        fps = 1.0 / max(time.time() - t0, 1e-6)
        cv2.putText(out, f"{fps:.1f} fps", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (255, 255, 255), 2)
        cv2.imshow("monorun_tpu_torch", out)
        if cv2.waitKey(1) & 0xFF == ord("q"):
            break
    cap.release()
    cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
