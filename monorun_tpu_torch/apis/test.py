"""Evaluation loop: dataset -> batched inference -> KITTI AP; the PyTorch
counterpart of ``monorun_tpu/apis/test.py:run_eval``.

Batched (the reference forces samples_per_gpu=1, tools/test.py:160-162),
with host data loading overlapped against device compute by the prefetch
loader. Each batch goes to the session's device in one copy per input
(``apis/inference.py:upload``) and its detections come back in one copy
per field (``detections_to_host``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from ..data.kitti import KITTI3DDataset
from ..data.loader import PrefetchLoader
from .inference import InferenceSession, detections_to_host


def run_eval(
    session: InferenceSession,
    ds: KITTI3DDataset,
    batch_size: int = 4,
    metrics=("bbox", "bev", "3d"),
    result_dir: Optional[str] = None,
    print_summary: bool = True,
    progress: bool = True,
    show_dir: Optional[str] = None,
    show_score_thr: float = 0.3,
    distributed: bool = False,
) -> Dict[str, float]:
    """Detect every image of ``ds`` with ``session`` (``raw=False``) and
    evaluate; returns the AP dict (empty without labels). Each batch's
    draws are seeded with its first dataset index, as in the JAX
    package."""
    if distributed:
        raise NotImplementedError(
            "distributed evaluation comes with the port's multi-GPU slice "
            "(torch.distributed)"
        )
    cfg = session.cfg
    loader = PrefetchLoader(
        ds, cfg.data, batch_size, train=False, shuffle=False, drop_last=False,
    )
    results = [None] * len(ds)
    n_done = 0
    inv_s = 1.0 / float(cfg.data.test_scale)
    t0 = time.time()
    for batch in loader:
        det, extras = detections_to_host(session.run(
            batch["images"], batch["cam"], batch["img_shapes"],
            seed=int(batch["_indices"][0]),
        ))
        for b, idx in enumerate(batch["_indices"]):
            idx = int(idx)
            if results[idx] is not None:
                continue   # wrapped tail duplicate
            # fast-preset downscale: 2D boxes back to native image coords
            # (3D outputs are metric already: the intrinsics were scaled
            # with the image in prepare_test_sample)
            res = dict(
                bboxes_2d=det["bboxes_2d"][b] * inv_s,
                labels=det["labels"][b],
                bboxes_3d=det["bboxes_3d"][b],
                valid=det["valid"][b],
                pose_cov=det["pose_cov"][b],
            )
            # cfg.test.debug extras feed the BEV reconstruction scatter in
            # the visualizer (image_bev_vis.py:119-141)
            res.update({k: v[b] for k, v in extras.items()})
            results[idx] = res
            n_done += 1
            if show_dir is not None:
                _show(ds, idx, res, show_dir, show_score_thr)
        if progress:
            rate = n_done / max(time.time() - t0, 1e-9)
            print(f"\r[eval] {n_done}/{len(ds)} ({rate:.1f} img/s)", end="",
                  flush=True)
    if progress:
        print()
    return ds.evaluate(
        results, metrics=metrics, result_dir=result_dir,
        print_summary=print_summary,
    )


def _show(ds: KITTI3DDataset, idx: int, res: dict, show_dir: str,
          score_thr: float) -> None:
    import cv2

    from ..utils.visualizer import show_result

    os.makedirs(show_dir, exist_ok=True)
    path = ds.image_path(idx)
    show_result(
        cv2.imread(path), res, ds.get_ann(idx)["cam_intrinsic"],
        out_file=os.path.join(show_dir, os.path.basename(path)),
        score_thr=score_thr,
    )
