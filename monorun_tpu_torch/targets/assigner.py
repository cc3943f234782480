"""Max-IoU assignment, fixed-shape (mmdet MaxIoUAssigner semantics), the
PyTorch counterpart of ``monorun_tpu/targets/assigner.py``.

Padded GT slots carry a validity mask instead of varying array lengths;
ignore boxes suppress candidates by intersection over foreground.
Assignment codes: ``ASSIGN_IGNORE`` (-2) overlaps an ignore region or is
in between the thresholds, ``ASSIGN_NEG`` (-1) background, >= 0 the index
of the matched GT. One image per call (the JAX package vmaps the same
function over the batch).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops.nms import bbox_iof_matrix, bbox_iou_matrix

Tensor = torch.Tensor

ASSIGN_IGNORE = -2
ASSIGN_NEG = -1


@dataclasses.dataclass(frozen=True)
class AssignCfg:
    pos_iou_thr: float
    neg_iou_thr: float
    min_pos_iou: float
    ignore_iof_thr: float = -1.0
    match_low_quality: bool = True


class AssignResult(NamedTuple):
    assigned_gt: Tensor    # (n,) int64 codes as above
    max_iou: Tensor        # (n,)
    labels: Tensor         # (n,) class of the matched GT, -1 otherwise


def assign_max_iou(
    boxes: Tensor,          # (n, 4) candidate boxes
    boxes_valid: Tensor,    # (n,) bool
    gt_boxes: Tensor,       # (g, 4) padded
    gt_valid: Tensor,       # (g,) bool
    gt_labels: Tensor,      # (g,) int
    cfg: AssignCfg,
    ignore_boxes: Optional[Tensor] = None,   # (i, 4) padded
    ignore_valid: Optional[Tensor] = None,   # (i,) bool
) -> AssignResult:
    """Assignment is a step function of the boxes: it carries no gradient."""
    boxes, gt_boxes = boxes.detach(), gt_boxes.detach()
    n, g = boxes.shape[0], gt_boxes.shape[0]
    zero = boxes.new_zeros(())
    iou = bbox_iou_matrix(boxes, gt_boxes)                  # (n, g)
    iou = torch.where(gt_valid[None, :], iou, zero)
    iou = torch.where(boxes_valid[:, None], iou, zero)

    max_iou, argmax_gt = iou.max(1)
    assigned = torch.full((n,), ASSIGN_IGNORE, dtype=torch.long, device=boxes.device)
    assigned = torch.where(max_iou < cfg.neg_iou_thr, ASSIGN_NEG, assigned)
    assigned = torch.where(max_iou >= cfg.pos_iou_thr, argmax_gt, assigned)

    if cfg.match_low_quality:
        # every GT claims its best-overlapping candidates when that overlap
        # reaches min_pos_iou (all of them on a tie); later GTs override
        # earlier ones, like mmdet's sequential loop
        gt_max = iou.max(0).values                          # (g,)
        is_gt_best = ((iou == gt_max[None, :]) & (gt_max[None, :] >= cfg.min_pos_iou)
                      & gt_valid[None, :] & (iou > 0))
        ids = torch.arange(g, device=boxes.device)[None, :]
        claim = torch.where(is_gt_best, ids, torch.full_like(ids, -1))
        best_claim = claim.max(1).values
        assigned = torch.where(best_claim >= 0, best_claim, assigned)

    if ignore_boxes is not None and ignore_valid is not None and cfg.ignore_iof_thr > 0:
        iof = bbox_iof_matrix(boxes, ignore_boxes.detach())
        iof = torch.where(ignore_valid[None, :], iof, zero)
        iof = torch.cat([iof, iof.new_zeros(n, 1)], 1)      # max with initial 0
        hit = iof.max(1).values >= cfg.ignore_iof_thr
        assigned = torch.where(hit, ASSIGN_IGNORE, assigned)

    assigned = torch.where(boxes_valid, assigned, ASSIGN_IGNORE)
    labels = torch.where(assigned >= 0, gt_labels.long()[assigned.clamp(min=0)], -1)
    return AssignResult(assigned, max_iou, labels)
