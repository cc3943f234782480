"""Fixed-shape NMS (axis-aligned and rotated-BEV), the PyTorch counterpart
of ``monorun_tpu/ops/nms.py``.

Greedy NMS keeps box i iff no earlier-ranked kept box j overlaps it above
the threshold. Its keep set is the unique fixpoint of
keep[i] = valid[i] and not any_{j<i} keep[j] and iou(j, i) > thr, so
both strategies iterate that recurrence on a score-sorted IoU matrix:

* ``exact=True`` iterates to convergence (the greedy set);
* ``exact=False`` applies a fixed even number of rounds, which resolves
  suppression chains up to that depth and upper-bounds the greedy set on
  deeper ones (``rpn.py`` uses 16, the 3D NMS the slot count, where it is
  exact).

Every function is batched over leading dimensions: boxes (..., n, d),
scores (..., n). Invalid entries carry the score ``NEG_INF``. Sorting is
stable throughout, so ties resolve by index as ``jnp.argsort`` and
``jax.lax.top_k`` do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .rotated_iou import rotated_iou

Tensor = torch.Tensor

NEG_INF = -1e10


def bbox_iou_matrix(boxes_a: Tensor, boxes_b: Tensor) -> Tensor:
    """Axis-aligned IoU, (..., n, 4) x (..., k, 4) -> (..., n, k)."""
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]).clamp(min=0) * (
        boxes_a[..., 3] - boxes_a[..., 1]
    ).clamp(min=0)
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]).clamp(min=0) * (
        boxes_b[..., 3] - boxes_b[..., 1]
    ).clamp(min=0)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-8)


def _suppression(iou: Tensor, iou_thr: float) -> Tensor:
    """sup[..., j, i]: j ranks before i and overlaps it above iou_thr."""
    n = iou.shape[-1]
    earlier = torch.ones(n, n, dtype=torch.bool, device=iou.device).triu(1)
    return (iou > iou_thr) & earlier


def _round(sup: Tensor, keep: Tensor, valid: Tensor) -> Tensor:
    killed = (sup & keep[..., :, None]).any(dim=-2)
    return valid & ~killed


def _suppress_greedy(iou: Tensor, valid: Tensor, iou_thr: float) -> Tensor:
    """Exact greedy keep mask: the recurrence run to its fixpoint, which it
    reaches within chain depth + 1 <= n + 1 rounds."""
    sup = _suppression(iou, iou_thr)
    keep = valid
    for _ in range(iou.shape[-1] + 1):
        nxt = _round(sup, keep, valid)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    return keep


def _suppress_fixpoint(
    iou: Tensor, valid: Tensor, iou_thr: float, iters: int
) -> Tensor:
    sup = _suppression(iou, iou_thr)
    keep = valid
    # an even number of rounds upper-bounds the greedy set
    for _ in range(2 * ((iters + 1) // 2)):
        keep = _round(sup, keep, valid)
    return keep


def _nms_impl(
    iou_fn, boxes: Tensor, scores: Tensor, iou_thr: float, max_out: int,
    exact: bool, fixpoint_iters: int,
) -> Tuple[Tensor, Tensor]:
    n = scores.shape[-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    valid = torch.gather(scores, -1, order) > NEG_INF / 2
    sorted_boxes = torch.gather(
        boxes, -2, order[..., None].expand(boxes.shape)
    )
    iou_sorted = iou_fn(sorted_boxes)
    if exact:
        kept = _suppress_greedy(iou_sorted, valid, iou_thr)
    else:
        kept = _suppress_fixpoint(iou_sorted, valid, iou_thr, fixpoint_iters)
    # kept boxes first (already score-sorted), then take max_out
    ar = torch.arange(n, device=scores.device).expand(kept.shape)
    kept_rank = torch.where(kept, ar, torch.full_like(ar, n))
    take = torch.sort(kept_rank, dim=-1, stable=True).indices[..., :max_out]
    return torch.gather(order, -1, take), torch.gather(kept, -1, take)


def nms(
    boxes: Tensor,        # (..., n, 4) xyxy
    scores: Tensor,       # (..., n), padded entries = NEG_INF
    iou_thr: float,
    max_out: int,
    exact: bool = True,
    fixpoint_iters: int = 12,
) -> Tuple[Tensor, Tensor]:
    """Axis-aligned NMS -> (keep_idx (..., max_out), keep_valid)."""
    return _nms_impl(
        lambda b: bbox_iou_matrix(b, b), boxes, scores, iou_thr, max_out,
        exact, fixpoint_iters,
    )


def nms_rotated_bev(
    boxes: Tensor,        # (..., n, 5) [x, z, l, w, ry]
    scores: Tensor,
    iou_thr: float,
    max_out: int,
    exact: bool = True,
    fixpoint_iters: int = 12,
) -> Tuple[Tensor, Tensor]:
    """Rotated-BEV NMS; ``fixpoint_iters >= n`` makes the fixpoint exact."""
    return _nms_impl(
        lambda b: rotated_iou(b, b), boxes, scores, iou_thr, max_out, exact,
        fixpoint_iters,
    )


def multiclass_nms(
    boxes: Tensor,        # (..., n, num_classes, 4) or (..., n, 4)
    scores: Tensor,       # (..., n, num_classes), thresholded to NEG_INF
    iou_thr: float,
    max_per_img: int,
    pre_topk: int = 512,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class NMS through the coordinate-offset trick (one exact pass).

    Returns (det_bboxes (..., m, 4), det_scores (..., m), det_labels
    (..., m), det_valid (..., m)) with m = max_per_img.
    """
    lead = scores.shape[:-2]
    n, num_classes = scores.shape[-2:]
    if boxes.dim() == scores.dim():
        boxes = boxes[..., None, :].expand(lead + (n, num_classes, 4))
    flat_boxes = boxes.reshape(lead + (n * num_classes, 4))
    flat_scores = scores.reshape(lead + (n * num_classes,))
    flat_labels = torch.arange(num_classes, device=scores.device).repeat(n)

    k = min(pre_topk, n * num_classes)
    top = torch.sort(flat_scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top.values[..., :k], top.indices[..., :k]
    top_boxes = torch.gather(
        flat_boxes, -2, top_idx[..., None].expand(lead + (k, 4))
    )
    top_labels = flat_labels[top_idx]

    # offset boxes per class so cross-class pairs never overlap
    extent = top_boxes.abs().amax(dim=(-2, -1), keepdim=True) + 1.0
    offset_boxes = top_boxes + (top_labels[..., None] * 2 * extent)

    keep_idx, keep_valid = nms(
        offset_boxes, top_scores, iou_thr, max_per_img, exact=True
    )
    det_boxes = torch.gather(
        top_boxes, -2, keep_idx[..., None].expand(keep_idx.shape + (4,))
    )
    det_scores = torch.where(
        keep_valid, torch.gather(top_scores, -1, keep_idx),
        torch.full_like(top_scores[..., :1], NEG_INF),
    )
    det_labels = torch.where(
        keep_valid, torch.gather(top_labels, -1, keep_idx),
        torch.full_like(top_labels[..., :1], -1),
    )
    return det_boxes, det_scores, det_labels, keep_valid
