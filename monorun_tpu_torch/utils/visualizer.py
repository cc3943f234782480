"""Visualisation: camera-view 3D wireframes + BEV map with uncertainty.

Equivalent of core/visualizer/image_bev_vis.py: projected 3D box
wireframes with near-plane clipping, and a bird's-eye-view canvas with
field-of-view rays, per-detection translation-covariance ellipses (95%),
and optionally the dense reconstructed object points colored by image RGB.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import cv2
import numpy as np

PALETTE = [
    (68, 182, 85), (58, 122, 243), (255, 140, 52),
    (211, 67, 177), (64, 196, 212), (230, 72, 72),
]
Z_MIN = 0.1


def box3d_corners(box: np.ndarray) -> np.ndarray:
    """[l, h, w, x, y, z, ry] -> (8, 3) corners (camera frame, y down,
    bottom-origin translation like KITTI)."""
    l, h, w = box[0], box[1], box[2]
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    y = np.array([0, 0, 0, 0, -h, -h, -h, -h])
    z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    ry = box[6]
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pts = np.stack([x, y, z], -1) @ rot.T
    return pts + box[3:6]

_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def _clip_segment(p0, p1, z_min=Z_MIN):
    """Clip a 3D segment against the near plane z = z_min."""
    z0, z1 = p0[2], p1[2]
    if z0 < z_min and z1 < z_min:
        return None
    if z0 >= z_min and z1 >= z_min:
        return p0, p1
    t = (z_min - z0) / (z1 - z0)
    pc = p0 + t * (p1 - p0)
    return (pc, p1) if z0 < z_min else (p0, pc)


def draw_boxes_3d(
    img: np.ndarray,               # HxWx3 uint8 (BGR, drawn in place)
    boxes_3d: np.ndarray,          # (n, 8) [l,h,w,x,y,z,ry,score]
    labels: np.ndarray,
    cam: np.ndarray,               # (3, 3)
    score_thr: float = 0.3,
    thickness: int = 2,
) -> np.ndarray:
    for box, lab in zip(boxes_3d, labels):
        if box[7] < score_thr:
            continue
        color = PALETTE[int(lab) % len(PALETTE)]
        corners = box3d_corners(box)
        for i, j in _EDGES:
            seg = _clip_segment(corners[i], corners[j])
            if seg is None:
                continue
            uv = []
            for p in seg:
                q = cam @ p
                uv.append((int(q[0] / q[2]), int(q[1] / q[2])))
            cv2.line(img, uv[0], uv[1], color, thickness, cv2.LINE_AA)
        # heading: front-face cross
        for i, j in [(0, 5), (1, 4)]:
            seg = _clip_segment(corners[i], corners[j])
            if seg is None:
                continue
            uv = []
            for p in seg:
                q = cam @ p
                uv.append((int(q[0] / q[2]), int(q[1] / q[2])))
            cv2.line(img, uv[0], uv[1], color, 1, cv2.LINE_AA)
    return img


def draw_cov_ellipse(canvas, center, cov2d, to_px, color, chi2_95=5.991):
    """95% covariance ellipse of (x, z) translation on the BEV canvas."""
    vals, vecs = np.linalg.eigh(cov2d)
    vals = np.clip(vals, 1e-6, None)
    angle = np.degrees(np.arctan2(vecs[1, 1], vecs[0, 1]))
    axes = np.sqrt(vals * chi2_95)
    c = to_px(center)
    scale = abs(to_px((1.0, 0.0))[0] - to_px((0.0, 0.0))[0])
    cv2.ellipse(
        canvas, c, (max(int(axes[1] * scale), 1), max(int(axes[0] * scale), 1)),
        -angle, 0, 360, color, 1, cv2.LINE_AA,
    )


def scatter_reconstruction(
    canvas: np.ndarray,
    to_px,
    boxes_3d: np.ndarray,          # (n, 8) [l,h,w,x,y,z,ry,score]
    bboxes_2d: np.ndarray,         # (n, 4+) image-space boxes
    oc_maps: np.ndarray,           # (n, d, d, 3) NOC-decoded object coords
    std_maps: np.ndarray,          # (n, d, d, 2) projection stds
    image_bgr: np.ndarray,
    score_thr: float,
) -> None:
    """Reconstructed object points on the BEV canvas, colored by the RGB
    of the detection's image crop (image_bev_vis.py:119-141): each dense
    NOC point is rotated/translated by the estimated pose, points whose
    projection-std exceeds 2x the per-object mean are dropped, and the
    survivors are painted far-to-near so nearer surfaces overdraw."""
    h, w = canvas.shape[:2]
    d = oc_maps.shape[1]
    for j in range(len(boxes_3d)):
        if boxes_3d[j, 7] < score_thr:
            continue
        std = std_maps[j].mean(axis=-1)                      # (d, d)
        mask = std < 2.0 * std.mean()
        if not mask.any():
            continue
        ry, t = boxes_3d[j, 6], boxes_3d[j, 3:6]
        c, s = np.cos(ry), np.sin(ry)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        oc = oc_maps[j][mask]                                # (np, 3)
        order = np.argsort(oc[:, 1])[::-1]                   # bottom first
        pts = oc[order] @ rot.T + t
        x1, y1, x2, y2 = [int(round(float(v))) for v in bboxes_2d[j, :4]]
        x2, y2 = max(x2, x1 + 1), max(y2, y1 + 1)
        crop = image_bgr[
            max(y1, 0): max(y2, 1), max(x1, 0): max(x2, 1)
        ]
        if crop.size == 0:
            continue
        rgb = cv2.resize(crop, (d, d))[mask][order]          # (np, 3)
        px = np.stack([p for p in map(to_px, pts[:, [0, 2]])])
        ok = (
            (px[:, 0] >= 0) & (px[:, 0] < w)
            & (px[:, 1] >= 0) & (px[:, 1] < h)
        )
        canvas[px[ok, 1], px[ok, 0]] = rgb[ok]


def show_bev(
    boxes_3d: np.ndarray,          # (n, 8)
    labels: np.ndarray,
    cam: np.ndarray,
    pose_covs: Optional[np.ndarray] = None,   # (n, 4, 4) [yaw, t] cov
    img_width: int = 1242,
    canvas_size: Tuple[int, int] = (420, 620),
    z_range: float = 70.0,
    score_thr: float = 0.3,
    bboxes_2d: Optional[np.ndarray] = None,
    oc_maps: Optional[np.ndarray] = None,      # (n, d, d, 3) debug extras
    std_maps: Optional[np.ndarray] = None,     # (n, d, d, 2)
    image_bgr: Optional[np.ndarray] = None,
) -> np.ndarray:
    h, w = canvas_size
    canvas = np.full((h, w, 3), 30, np.uint8)
    px_per_m = h / z_range

    def to_px(xz):
        return (int(w / 2 + xz[0] * px_per_m), int(h - xz[1] * px_per_m))

    # FOV rays from the camera through the image borders
    for u in (0.0, float(img_width)):
        d = np.linalg.solve(cam, np.array([u, 0, 1.0]))
        far = (d[0] / max(d[2], 1e-6) * z_range, z_range)
        cv2.line(canvas, to_px((0, 0)), to_px(far), (80, 80, 80), 1)
    for z in range(10, int(z_range) + 1, 10):
        cv2.circle(canvas, to_px((0, 0)), int(z * px_per_m), (55, 55, 55), 1)

    if oc_maps is not None and image_bgr is not None and len(boxes_3d):
        scatter_reconstruction(
            canvas, to_px, boxes_3d, bboxes_2d, oc_maps, std_maps,
            image_bgr, score_thr,
        )

    for i, (box, lab) in enumerate(zip(boxes_3d, labels)):
        if box[7] < score_thr:
            continue
        color = PALETTE[int(lab) % len(PALETTE)]
        l, wd = box[0], box[2]
        x, z, ry = box[3], box[5], box[6]
        c, s = np.cos(ry), np.sin(ry)
        pts = np.array(
            [[l / 2, wd / 2], [l / 2, -wd / 2],
             [-l / 2, -wd / 2], [-l / 2, wd / 2]]
        ) @ np.array([[c, s], [-s, c]]) + [x, z]
        poly = np.array([to_px(p) for p in pts], np.int32)
        cv2.polylines(canvas, [poly], True, color, 2, cv2.LINE_AA)
        front = to_px(((pts[0] + pts[1]) / 2))
        cv2.circle(canvas, front, 2, color, -1)
        if pose_covs is not None:
            draw_cov_ellipse(
                canvas, (x, z), pose_covs[i][np.ix_([1, 3], [1, 3])],
                to_px, color,
            )
    return canvas


def show_result(
    image_bgr: np.ndarray,
    result: Dict[str, np.ndarray],
    cam: np.ndarray,
    out_file: Optional[str] = None,
    score_thr: float = 0.3,
) -> np.ndarray:
    """Camera view above BEV view, like MonoRUnDetector.show_result.

    When the result carries the debug extras (cfg.test.debug: oc_maps
    (M, d, d, 3) + std_maps), the BEV additionally shows the dense
    reconstructed object points colored by the detection's image RGB."""
    img = image_bgr.copy()
    keep = result["valid"]
    boxes = result["bboxes_3d"][keep]
    labels = result["labels"][keep]
    covs = result.get("pose_cov")
    covs = covs[keep] if covs is not None else None
    oc_maps = result.get("oc_maps")
    draw_boxes_3d(img, boxes, labels, cam, score_thr)
    bev = show_bev(
        boxes, labels, cam, covs, img_width=img.shape[1],
        canvas_size=(420, img.shape[1]), score_thr=score_thr,
        bboxes_2d=result["bboxes_2d"][keep],
        oc_maps=oc_maps[keep] if oc_maps is not None else None,
        std_maps=(
            result["std_maps"][keep] if oc_maps is not None else None
        ),
        image_bgr=image_bgr,
    )
    out = np.concatenate([img, bev], axis=0)
    if out_file:
        cv2.imwrite(out_file, out)
    return out
