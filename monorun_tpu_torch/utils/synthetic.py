"""Synthetic fixture batches (no KITTI on disk) for tests, dryruns and
the chip smoke run: a copy of ``monorun_tpu/utils/synthetic.py`` (numpy
only), so the port and the JAX package draw the same batches from a seed."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..config import MonoRUnConfig


def synthetic_train_batch(
    cfg: MonoRUnConfig,
    batch: int,
    image_shape: Tuple[int, int],
    num_gt: int = 8,
    num_pts: int = 64,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """KITTI-plausible random batch matching train_forward's contract."""
    h, w = image_shape
    rng = np.random.default_rng(seed)
    G = cfg.data.max_gt if num_gt is None else num_gt
    K = len(cfg.data.classes)

    gt_valid = np.zeros((batch, G), bool)
    gt_valid[:, : max(1, G // 2)] = True
    x1 = rng.uniform(0, w * 0.7, (batch, G))
    y1 = rng.uniform(0, h * 0.6, (batch, G))
    bw = rng.uniform(w * 0.05, w * 0.3, (batch, G))
    bh = rng.uniform(h * 0.1, h * 0.4, (batch, G))
    gt_boxes = np.stack(
        [x1, y1, np.minimum(x1 + bw, w - 1), np.minimum(y1 + bh, h - 1)], -1
    ).astype(np.float32)

    dims = np.stack(
        [rng.uniform(3, 4.5, (batch, G)), rng.uniform(1.4, 1.8, (batch, G)),
         rng.uniform(1.5, 1.9, (batch, G))], -1,
    )
    xyz = np.stack(
        [rng.uniform(-8, 8, (batch, G)), rng.uniform(0.8, 1.8, (batch, G)),
         rng.uniform(8, 40, (batch, G))], -1,
    )
    ry = rng.uniform(-np.pi, np.pi, (batch, G, 1))
    gt_bboxes_3d = np.concatenate([dims, xyz, ry], -1).astype(np.float32)

    fx = w * 0.56
    cam = np.tile(
        np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32),
        (batch, 1, 1),
    )

    uv = np.stack(
        [rng.uniform(0, w, (batch, G, num_pts)),
         rng.uniform(0, h, (batch, G, num_pts))], -1,
    ).astype(np.float32)
    oc = rng.uniform(-1, 1, (batch, G, num_pts, 3)).astype(np.float32) * (
        dims[..., None, :] / 2
    ).astype(np.float32)
    pts_valid = rng.uniform(size=(batch, G, num_pts)) > 0.3

    return dict(
        images=rng.normal(0, 1, (batch, h, w, 3)).astype(np.float32),
        cam=cam,
        img_shapes=np.tile(
            np.asarray([[float(h), float(w)]], np.float32), (batch, 1)
        ),
        scale_factor=np.ones((batch, 2), np.float32),
        crop_offset=np.zeros((batch, 2), np.float32),
        gt_boxes=gt_boxes,
        gt_labels=rng.integers(0, K, (batch, G)).astype(np.int32),
        gt_valid=gt_valid,
        ignore_boxes=np.zeros((batch, 4, 4), np.float32),
        ignore_valid=np.zeros((batch, 4), bool),
        gt_bboxes_3d=gt_bboxes_3d,
        flip=rng.uniform(size=(batch,)) < 0.5,
        uv=uv,
        oc=oc,
        pts_valid=pts_valid,
    )


def synthetic_scene_batch(
    cfg: MonoRUnConfig,
    batch: int,
    image_shape: Tuple[int, int],
    num_gt: int = 4,
    num_pts: int = 64,
    seed: int = 0,
    n_objects: int = 2,
    z_range: Tuple[float, float] = (4.5, 7.0),
    u_span: Tuple[float, float] = (0.25, 0.75),
) -> Dict[str, np.ndarray]:
    """Geometrically CONSISTENT synthetic KITTI scenes.

    ``synthetic_train_batch`` draws uv/oc as independent noise — enough
    for shape/finiteness tests, but the NOC supervision it yields is
    garbage, so PnP can never recover a pose and ``mean_iou`` stays ~0
    no matter how long training runs. Here every field comes from a true
    pinhole scene (the in-env analogue of the reference's KITTI +
    LiDAR-object-coordinate data, pipelines/loading.py:28-50):

    * objects are KITTI-convention 3D boxes [l,h,w,x,y,z,ry] (bottom-
      center origin, camera frame X_cam = R_y(ry) X_obj + t);
    * each pixel covered by a box is ray-cast (slab test in the object
      frame) to its true object-frame surface coordinate; the IMAGE
      TEXTURE is the z-scored NOC encoding of that coordinate, so the
      NOC head can actually learn appearance -> NOC;
    * sparse supervision (uv, oc) samples the rasterized pixels, so
      projecting oc through the GT pose lands exactly on uv;
    * gt 2D boxes are the rasterized-pixel bounds (truncation-exact).

    Occlusion is handled by far-to-near painting. All objects are Car
    (label 0); flip is False (geometry stays in the original frame).
    """
    h, w = image_shape
    rng = np.random.default_rng(seed)
    G = num_gt
    fx = fy = 1.4 * h
    cx, cy = w / 2.0, h / 2.0
    K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    noc_means = np.asarray(cfg.noc_head.noc_means, np.float32)
    noc_stds = np.asarray(cfg.noc_head.noc_stds, np.float32)

    # pixel-center ray grid, shared across images
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy,
                     np.ones_like(uu)], -1).reshape(-1, 3)      # (hw, 3)

    images = (rng.normal(0, 0.25, (batch, h, w, 3))).astype(np.float32)
    gt_boxes = np.zeros((batch, G, 4), np.float32)
    gt_valid = np.zeros((batch, G), bool)
    gt_bboxes_3d = np.zeros((batch, G, 7), np.float32)
    uv_out = np.zeros((batch, G, num_pts, 2), np.float32)
    oc_out = np.zeros((batch, G, num_pts, 3), np.float32)
    pts_valid = np.zeros((batch, G, num_pts), bool)

    n_obj = min(n_objects, G)
    u_slots = np.linspace(u_span[0], u_span[1], max(n_obj, 1)) * w

    for b in range(batch):
        # far-to-near draw order for correct occlusion
        zs = np.sort(rng.uniform(*z_range, n_obj))[::-1]
        owner = np.full(h * w, -1, np.int32)
        oc_px = np.zeros((h * w, 3), np.float32)
        for j in range(n_obj):
            L = rng.uniform(3.4, 4.4)
            Hh = rng.uniform(1.4, 1.7)
            W3 = rng.uniform(1.5, 1.8)
            z = zs[j]
            u_c = u_slots[j] + rng.uniform(-0.05, 0.05) * w
            v_c = (0.5 + rng.uniform(0.0, 0.1)) * h
            x = (u_c - cx) * z / fx
            y = (v_c - cy) * z / fy + Hh / 2.0
            ry = rng.uniform(-np.pi, np.pi)
            c, s = np.cos(ry), np.sin(ry)
            R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            t = np.asarray([x, y, z], np.float32)

            o_o = -R.T @ t                                   # ray origin
            d_o = rays @ R                                   # (hw, 3) R^T d
            lo = np.asarray([-L / 2, -Hh, -W3 / 2], np.float32)
            hi = np.asarray([L / 2, 0.0, W3 / 2], np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (lo - o_o) / d_o
                t2 = (hi - o_o) / d_o
            tmin = np.nanmax(np.minimum(t1, t2), axis=1)
            tmax = np.nanmin(np.maximum(t1, t2), axis=1)
            hit = (tmax >= np.maximum(tmin, 1e-3)) & (tmin > 0)
            if not hit.any():
                continue
            pts = o_o + tmin[hit, None] * d_o[hit]           # object frame
            owner[hit] = j
            oc_px[hit] = pts

            ij = np.flatnonzero(hit)
            py, px = ij // w, ij % w
            gt_boxes[b, j] = (px.min(), py.min(), px.max() + 1.0,
                              py.max() + 1.0)
            gt_valid[b, j] = True
            gt_bboxes_3d[b, j] = (L, Hh, W3, x, y, z, ry)

        for j in range(n_obj):
            if not gt_valid[b, j]:
                continue
            ij = np.flatnonzero(owner == j)                  # visible only
            if ij.size == 0:
                gt_valid[b, j] = False
                continue
            dims_j = gt_bboxes_3d[b, j, :3]
            parts = (oc_px[ij] / np.clip(dims_j, 1e-5, None)
                     - noc_means) / noc_stds
            py, px = ij // w, ij % w
            images[b, py, px] = parts                        # NOC texture
            sel = rng.choice(ij.size, size=num_pts,
                             replace=ij.size < num_pts)
            uv_out[b, j, :, 0] = px[sel].astype(np.float32)
            uv_out[b, j, :, 1] = py[sel].astype(np.float32)
            oc_out[b, j] = oc_px[ij[sel]]
            pts_valid[b, j] = True

    cam = np.tile(K, (batch, 1, 1))
    return dict(
        images=images,
        cam=cam,
        img_shapes=np.tile(
            np.asarray([[float(h), float(w)]], np.float32), (batch, 1)
        ),
        scale_factor=np.ones((batch, 2), np.float32),
        crop_offset=np.zeros((batch, 2), np.float32),
        gt_boxes=gt_boxes,
        gt_labels=np.zeros((batch, G), np.int32),
        gt_valid=gt_valid,
        ignore_boxes=np.zeros((batch, 4, 4), np.float32),
        ignore_valid=np.zeros((batch, 4), bool),
        gt_bboxes_3d=gt_bboxes_3d,
        flip=np.zeros((batch,), bool),
        uv=uv_out,
        oc=oc_out,
        pts_valid=pts_valid,
    )
