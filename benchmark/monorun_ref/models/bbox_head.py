"""Shared-2FC R-CNN bbox head (mmdet Shared2FCBBoxHead), the PyTorch
counterpart of ``monorun_tpu/models/bbox_head.py``.

7x7xC RoI features -> two FCs -> softmax class scores (num_classes + 1,
background last) and per-class box deltas. The first FC's weight keeps
torch's (C, H, W) flatten order, so the NHWC RoI features are flattened
channel-major.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BBoxHeadConfig
from ..ops.box_coder import delta_decode
from ..ops.nms import NEG_INF, multiclass_nms
from .layers import Linear

Tensor = torch.Tensor


class BBoxHead(nn.Module):
    def __init__(self, cfg: BBoxHeadConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        area = c.roi_feat_size * c.roi_feat_size
        self.shared_fcs = nn.ModuleList([
            Linear(c.in_channels * area, c.fc_out_channels),
            Linear(c.fc_out_channels, c.fc_out_channels),
        ])
        self.fc_cls = Linear(c.fc_out_channels, c.num_classes + 1)
        n_reg = 4 if c.reg_class_agnostic else 4 * c.num_classes
        self.fc_reg = Linear(c.fc_out_channels, n_reg)

    def forward(self, roi_feats: Tensor) -> Tuple[Tensor, Tensor]:
        """(n, 7, 7, C) -> (cls_logits (n, K+1), deltas (n, 4K)), float32."""
        x = roi_feats.permute(0, 3, 1, 2).flatten(1)        # torch (C, H, W)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()


def get_det_bboxes(
    rois: Tensor,          # (..., n, 4) proposals (no batch column)
    cls_logits: Tensor,    # (..., n, K+1)
    deltas: Tensor,        # (..., n, 4K)
    roi_valid: Tensor,     # (..., n) bool
    img_shape: Tuple[int, int],
    cfg_head: BBoxHeadConfig,
    score_thr: float,
    nms_iou_thr: float,
    max_per_img: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """mmdet BBoxHead.get_bboxes + multiclass NMS, batched over leading
    dims. Returns (boxes (..., m, 4), scores, labels, valid (..., m))."""
    K = cfg_head.num_classes
    scores = torch.softmax(cls_logits, dim=-1)[..., :K]   # drop background
    if cfg_head.reg_class_agnostic:
        boxes = delta_decode(
            rois, deltas, cfg_head.target_means, cfg_head.target_stds,
            max_shape=img_shape,
        )
        boxes = boxes[..., None, :].expand(boxes.shape[:-1] + (K, 4))
    else:
        boxes = delta_decode(
            rois[..., None, :],
            deltas.reshape(deltas.shape[:-1] + (K, 4)),
            cfg_head.target_means, cfg_head.target_stds,
            max_shape=img_shape,
        )                                                  # (..., n, K, 4)
    keep = (scores > score_thr) & roi_valid[..., None]
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    return multiclass_nms(boxes, masked, nms_iou_thr, max_per_img)
