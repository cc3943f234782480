"""Numpy twin of ops/rotated_iou for host-side KITTI evaluation.

Same fixed-24-slot candidate construction (corners-in-quad + edge
intersections, angle sort, shoelace fan) as the device implementation;
replaces both numba-CUDA kernels the reference evaluates with
(core/evaluation/kitti_utils/rotate_iou.py).
"""

from __future__ import annotations

import numpy as np


def box_corners(boxes: np.ndarray) -> np.ndarray:
    cx, cy, w, h, ang = [boxes[..., i] for i in range(5)]
    cos, sin = np.cos(ang), np.sin(ang)
    dx = np.stack([-w, -w, w, w], -1) * 0.5
    dy = np.stack([-h, h, h, -h], -1) * 0.5
    x = cos[..., None] * dx + sin[..., None] * dy + cx[..., None]
    y = -sin[..., None] * dx + cos[..., None] * dy + cy[..., None]
    return np.stack([x, y], -1)


def _points_in_quad(pts, corners):
    a = corners[..., 0, :]
    ab = corners[..., 1, :] - a
    ad = corners[..., 3, :] - a
    ap = pts - a[..., None, :]
    abab = np.sum(ab * ab, -1)[..., None]
    adad = np.sum(ad * ad, -1)[..., None]
    abap = np.sum(ab[..., None, :] * ap, -1)
    adap = np.sum(ad[..., None, :] * ap, -1)
    tb = 1e-5 * abab
    td = 1e-5 * adad
    return (
        (abap >= -tb) & (abap <= abab + tb) & (adap >= -td)
        & (adap <= adad + td)
    )


def _edge_intersections(ca, cb):
    a = ca[..., :, None, :]
    b = np.roll(ca, -1, axis=-2)[..., :, None, :]
    c = cb[..., None, :, :]
    d = np.roll(cb, -1, axis=-2)[..., None, :, :]

    def cross(p, q, r):
        return (p[..., 0] - r[..., 0]) * (q[..., 1] - r[..., 1]) - (
            p[..., 1] - r[..., 1]
        ) * (q[..., 0] - r[..., 0])

    abc = cross(a, b, c)
    abd = cross(a, b, d)
    cda = cross(c, d, a)
    cdb = cda + abc - abd
    valid = (abc * abd < 0) & (cda * cdb < 0)
    denom = abd - abc
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = cda / denom
    pts = a + t[..., None] * (b - a)
    shp = pts.shape[:-3]
    return pts.reshape(shp + (16, 2)), valid.reshape(shp + (16,))


def intersection_area(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Element-wise intersection area; boxes (..., 5)."""
    ca = box_corners(boxes_a)
    cb = box_corners(boxes_b)
    in_ab = _points_in_quad(ca, cb)
    in_ba = _points_in_quad(cb, ca)
    ipts, ival = _edge_intersections(ca, cb)
    pts = np.concatenate([ca, cb, ipts], axis=-2)
    valid = np.concatenate([in_ab, in_ba, ival], -1)

    count = valid.sum(-1)
    vf = valid[..., None].astype(pts.dtype)
    centroid = (pts * vf).sum(-2) / np.clip(vf.sum(-2), 1.0, None)
    rel = pts - centroid[..., None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(valid, ang, 1e8)
    order = np.argsort(ang, axis=-1)
    sp = np.take_along_axis(pts, order[..., None], axis=-2)
    p0, p1, p2 = sp[..., 0:1, :], sp[..., 1:-1, :], sp[..., 2:, :]
    tri = 0.5 * np.abs(
        (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1])
        - (p1[..., 1] - p0[..., 1]) * (p2[..., 0] - p0[..., 0])
    )
    k = np.arange(tri.shape[-1])
    mask = (k + 2) < count[..., None]
    return np.where(mask, tri, 0.0).sum(-1)


def rotate_iou_matrix(
    boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1
) -> np.ndarray:
    """(n, 5) x (k, 5) -> (n, k) rotated IoU (criterion as in reference)."""
    n, k = len(boxes), len(qboxes)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    a = np.broadcast_to(boxes[:, None, :], (n, k, 5))
    b = np.broadcast_to(qboxes[None, :, :], (n, k, 5))
    inter = intersection_area(a, b)
    area_a = boxes[:, 2] * boxes[:, 3]
    area_b = qboxes[:, 2] * qboxes[:, 3]
    if criterion == -1:
        denom = area_a[:, None] + area_b[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a[:, None], (n, k)).copy()
    elif criterion == 1:
        denom = np.broadcast_to(area_b[None, :], (n, k)).copy()
    else:
        return inter
    return inter / np.clip(denom, 1e-8, None)


def d3_box_overlap(
    boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1
) -> np.ndarray:
    """Camera-frame 3D IoU matrix for [x,y,z,l,h,w,ry] boxes (y down)."""
    n, k = len(boxes), len(qboxes)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    bev_a = boxes[:, [0, 2, 3, 5, 6]]
    bev_b = qboxes[:, [0, 2, 3, 5, 6]]
    rinc = rotate_iou_matrix(bev_a, bev_b, criterion=2)
    ya, ha = boxes[:, 1:2], boxes[:, 4:5]
    yb, hb = qboxes[None, :, 1], qboxes[None, :, 4]
    top = np.minimum(ya, yb)
    bot = np.maximum(ya - ha, yb - hb)
    ih = np.clip(top - bot, 0, None)
    inter = ih * rinc
    vol_a = np.prod(boxes[:, 3:6], 1)[:, None]
    vol_b = np.prod(qboxes[:, 3:6], 1)[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(vol_b, inter.shape)
    else:
        return inter
    return np.clip(inter / np.clip(denom, 1e-6, None), 0.0, 1.0)
