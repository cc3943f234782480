"""Rotated-rectangle (BEV) intersection and IoU, the PyTorch counterpart
of ``monorun_tpu/ops/rotated_iou.py``.

Intersection polygon candidates = corners of A inside B + corners of B
inside A + the 16 edge-pair intersection points, in fixed 24-slot
buffers; the valid candidates are ordered by angle around their centroid
(a stable rank, ties broken by index) and summed with the shoelace fan.

Box format: (cx, cy, w, h, angle) with the clockwise-rotation corner
convention; for KITTI BEV use (x, z, l, w, ry).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_BIG = 1e8


def box_corners(boxes: Tensor) -> Tensor:
    """(..., 5) -> (..., 4, 2) corners."""
    cx, cy, w, h, ang = boxes.unbind(-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    dx = torch.stack([-w, -w, w, w], -1) * 0.5
    dy = torch.stack([-h, h, h, -h], -1) * 0.5
    x = cos[..., None] * dx + sin[..., None] * dy + cx[..., None]
    y = -sin[..., None] * dx + cos[..., None] * dy + cy[..., None]
    return torch.stack([x, y], -1)


def _points_in_quad(pts: Tensor, corners: Tensor) -> Tensor:
    """pts (..., P, 2) inside convex quad corners (..., 4, 2) -> (..., P)."""
    a = corners[..., 0, :]
    ab = corners[..., 1, :] - a
    ad = corners[..., 3, :] - a
    ap = pts - a[..., None, :]
    abab = (ab * ab).sum(-1)[..., None]
    adad = (ad * ad).sum(-1)[..., None]
    abap = (ab[..., None, :] * ap).sum(-1)
    adap = (ad[..., None, :] * ap).sum(-1)
    # relative tolerance: corners of identical boxes land on the boundary
    tol_b = 1e-5 * abab
    tol_d = 1e-5 * adad
    return (
        (abap >= -tol_b) & (abap <= abab + tol_b)
        & (adap >= -tol_d) & (adap <= adad + tol_d)
    )


def _edge_intersections(ca: Tensor, cb: Tensor):
    """All 16 edge-pair proper crossings of two quads (..., 4, 2)."""
    a = ca[..., :, None, :]
    b = torch.roll(ca, -1, dims=-2)[..., :, None, :]
    c = cb[..., None, :, :]
    d = torch.roll(cb, -1, dims=-2)[..., None, :, :]

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
    t = cda / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    pts = a + t[..., None] * (b - a)                  # (..., 4, 4, 2)
    shp = pts.shape[:-3]
    return pts.reshape(shp + (16, 2)), valid.reshape(shp + (16,))


def rotated_intersection_area(boxes_a: Tensor, boxes_b: Tensor) -> Tensor:
    """Intersection area of rotated rects with matching leading shapes."""
    ca = box_corners(boxes_a)
    cb = box_corners(boxes_b)
    in_ab = _points_in_quad(ca, cb)
    in_ba = _points_in_quad(cb, ca)
    inter_pts, inter_valid = _edge_intersections(ca, cb)

    pts = torch.cat([ca, cb, inter_pts], dim=-2)              # (..., 24, 2)
    valid = torch.cat([in_ab, in_ba, inter_valid], -1)        # (..., 24)

    count = valid.sum(-1)
    vf = valid[..., None].to(pts.dtype)
    centroid = (pts * vf).sum(-2) / vf.sum(-2).clamp(min=1.0)
    rel = pts - centroid[..., None, :]
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    ang = torch.where(valid, ang, torch.full_like(ang, _BIG))
    # stable ascending order of the candidates by angle
    order = torch.sort(ang, dim=-1, stable=True).indices
    sorted_pts = torch.gather(pts, -2, order[..., None].expand(pts.shape))

    # shoelace fan from the first (angle-sorted) valid point
    p0 = sorted_pts[..., 0:1, :]
    p1 = sorted_pts[..., 1:-1, :]
    p2 = sorted_pts[..., 2:, :]
    tri = 0.5 * (
        (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1])
        - (p1[..., 1] - p0[..., 1]) * (p2[..., 0] - p0[..., 0])
    ).abs()                                                   # (..., 22)
    k = torch.arange(tri.shape[-1], device=tri.device)
    tri_mask = (k + 2) < count[..., None]
    return torch.where(tri_mask, tri, torch.zeros_like(tri)).sum(-1)


def rotated_iou(boxes_a: Tensor, boxes_b: Tensor) -> Tensor:
    """Pairwise rotated IoU, (..., n, 5) x (..., k, 5) -> (..., n, k)."""
    n, k = boxes_a.shape[-2], boxes_b.shape[-2]
    lead = boxes_a.shape[:-2]
    a = boxes_a[..., :, None, :].expand(lead + (n, k, 5))
    b = boxes_b[..., None, :, :].expand(lead + (n, k, 5))
    inter = rotated_intersection_area(a, b)
    area_a = boxes_a[..., 2] * boxes_a[..., 3]
    area_b = boxes_b[..., 2] * boxes_b[..., 3]
    denom = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / denom.clamp(min=1e-8)
