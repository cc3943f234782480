"""RPN anchor targets and losses (fixed-shape), the PyTorch counterpart of
``monorun_tpu/targets/rpn_targets.py``.

mmdet semantics: max-IoU assignment (0.7 / 0.3, low-quality 0.3, ignore
IoF 0.5), a random sample of 256 at positive fraction 0.5, sigmoid BCE for
objectness and smooth L1 (beta 1/9) on the anchor deltas, both averaged
by the sampled count over the batch. Losses in float32.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..config import RPNConfig, TrainCfg
from ..losses import sigmoid_bce_loss, smooth_l1_loss
from ..ops.box_coder import delta_encode, multilevel_anchors
from .assigner import AssignCfg, assign_max_iou
from .sampler import sample_rois

Tensor = torch.Tensor


def rpn_loss(
    noise: Tuple[Tensor, Tensor],    # (B, N) sampler uniforms, positives and negatives
    cls_scores: Sequence[Tensor],    # per level (B, H, W, A) logits
    bbox_preds: Sequence[Tensor],    # per level (B, H, W, A*4)
    gt_boxes: Tensor,                # (B, G, 4)
    gt_valid: Tensor,                # (B, G)
    ignore_boxes: Tensor,            # (B, I, 4)
    ignore_valid: Tensor,            # (B, I)
    rpn_cfg: RPNConfig,
    train_cfg: TrainCfg,
) -> Dict[str, Tensor]:
    B = cls_scores[0].shape[0]
    dev = cls_scores[0].device
    feat_sizes = [(s.shape[1], s.shape[2]) for s in cls_scores]
    anchors = torch.cat(multilevel_anchors(
        feat_sizes, rpn_cfg.anchors.strides, rpn_cfg.anchors.scales,
        rpn_cfg.anchors.ratios, dev), 0)                       # (N, 4)
    n_anchors = anchors.shape[0]
    logits = torch.cat([s.reshape(B, -1) for s in cls_scores], 1).float()
    deltas = torch.cat([p.reshape(B, -1, 4) for p in bbox_preds], 1).float()

    acfg = AssignCfg(
        pos_iou_thr=train_cfg.rpn_pos_iou_thr,
        neg_iou_thr=train_cfg.rpn_neg_iou_thr,
        min_pos_iou=train_cfg.rpn_min_pos_iou,
        ignore_iof_thr=train_cfg.rpn_ignore_iof_thr,
    )
    num = train_cfg.rpn_num_samples
    max_pos = int(num * train_cfg.rpn_pos_fraction)
    every = torch.ones(n_anchors, dtype=torch.bool, device=dev)
    pos_inds, pos_valid, pos_targets, neg_inds, neg_valid = [], [], [], [], []
    for b in range(B):
        res = assign_max_iou(
            anchors, every, gt_boxes[b], gt_valid[b],
            torch.zeros(gt_boxes.shape[1], dtype=torch.long, device=dev), acfg,
            ignore_boxes=ignore_boxes[b], ignore_valid=ignore_valid[b],
        )
        samp = sample_rois((noise[0][b], noise[1][b]), anchors, res.assigned_gt,
                           res.labels, num, train_cfg.rpn_pos_fraction, max_pos=max_pos)
        pos_inds.append(samp.pos_inds)
        pos_valid.append(samp.pos_valid)
        pos_targets.append(delta_encode(samp.pos_boxes, gt_boxes[b][samp.pos_gt_inds],
                                        rpn_cfg.target_means, rpn_cfg.target_stds))
        neg_inds.append(samp.neg_inds)
        neg_valid.append(samp.neg_valid)
    pos_inds, pos_valid = torch.stack(pos_inds), torch.stack(pos_valid)
    neg_inds, neg_valid = torch.stack(neg_inds), torch.stack(neg_valid)
    pos_targets = torch.stack(pos_targets)

    num_total = pos_valid.sum() + neg_valid.sum()
    pos_logits = torch.gather(logits, 1, pos_inds)
    neg_logits = torch.gather(logits, 1, neg_inds)
    loss_cls = sigmoid_bce_loss(
        torch.cat([pos_logits, neg_logits], 1),
        torch.cat([torch.ones_like(pos_logits), torch.zeros_like(neg_logits)], 1),
        weight=torch.cat([pos_valid, neg_valid], 1).float(),
        avg_factor=num_total,
    )
    pos_deltas = torch.gather(deltas, 1, pos_inds[..., None].expand(-1, -1, 4))
    loss_bbox = smooth_l1_loss(
        pos_deltas, pos_targets, beta=1.0 / 9.0,
        weight=pos_valid[..., None].float(), avg_factor=num_total,
    )
    return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)
