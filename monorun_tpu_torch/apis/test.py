"""Evaluation loop: dataset -> batched inference -> KITTI AP; the PyTorch
counterpart of ``monorun_tpu/apis/test.py:run_eval``.

Batched (the reference forces samples_per_gpu=1, tools/test.py:160-162),
with host data loading overlapped against device compute by the prefetch
loader. Each batch goes to the session's device in one copy per input
(``apis/inference.py:upload``) and its detections come back in one copy
per field (``detections_to_host``).

Distributed evaluation (the reference's ``multi_gpu_test`` and
``collect_results``): each rank of the process group serves its strided
shard of the dataset (``parallel.dataset_shard``) with its own session,
and the per-image results are all-gathered (``parallel.allgather_results``)
so that every rank evaluates the whole list. With ``whole_batches`` a
rank detects whole batches of the one-process run instead (the training
loop's validation): every image keeps its batch and its batch's seed, so
the results are the one-process run's.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from ..data.kitti import KITTI3DDataset
from ..data.loader import PrefetchLoader
from ..parallel import allgather_results, dataset_shard, rank
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
    whole_batches: bool = False,
) -> Dict[str, float]:
    """Detect every image of ``ds`` with ``session`` (``raw=False``) and
    evaluate; returns the AP dict (empty without labels). Each batch's
    draws are seeded with its first dataset index, as in the JAX package.
    ``distributed``: this rank detects its shard, every rank evaluates the
    gathered results, and rank 0 alone writes ``result_dir`` and prints
    the summary (ranks on one host would write the same files).
    ``whole_batches`` (with ``distributed``): this rank detects its
    ``dataset_shard`` of the one-process run's batches of ``batch_size``,
    so each image is drawn for as at world size 1."""
    cfg = session.cfg
    indices = None
    if distributed:
        indices = (batch_shard(len(ds), batch_size) if whole_batches
                   else dataset_shard(len(ds)))
    loader = PrefetchLoader(
        ds, cfg.data, batch_size, train=False, shuffle=False, drop_last=False,
        indices=indices,
    )
    local: Dict[int, dict] = {}
    n_total = len(ds) if indices is None else len(indices)
    inv_s = 1.0 / float(cfg.data.test_scale)
    t0 = time.time()
    for batch in loader:
        det, extras = detections_to_host(session.run(
            batch["images"], batch["cam"], batch["img_shapes"],
            seed=int(batch["_indices"][0]),
        ))
        for b, idx in enumerate(batch["_indices"]):
            idx = int(idx)
            if idx in local:
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
            local[idx] = res
            if show_dir is not None:
                _show(ds, idx, res, show_dir, show_score_thr)
        if progress:
            rate = len(local) / max(time.time() - t0, 1e-9)
            print(f"\r[eval] {len(local)}/{n_total} ({rate:.1f} img/s)", end="",
                  flush=True)
    if progress:
        print()
    if distributed:
        results = allgather_results(local, len(ds))
        if rank() != 0:
            result_dir, print_summary = None, False
    else:
        results = [local.get(i) for i in range(len(ds))]
    return ds.evaluate(
        results, metrics=metrics, result_dir=result_dir,
        print_summary=print_summary,
    )


def batch_shard(n: int, batch_size: int) -> np.ndarray:
    """The images of this rank's ``dataset_shard`` of the ``batch_size``
    batches that a one-process run over ``n`` images makes."""
    batches = dataset_shard((n + batch_size - 1) // batch_size)
    return np.array([i for b in batches for i in range(b * batch_size,
                                                       min((b + 1) * batch_size, n))],
                    np.int64)


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
