"""RPN head and fixed-shape proposal generation, the PyTorch counterpart of
``monorun_tpu/models/rpn.py``.

mmdet v2 semantics: per-level top-k, delta decode and clip, per-level NMS
(``nms_across_levels=False``; the non-exact fixpoint at 16 rounds, as the
JAX package runs it), then a global top ``nms_post`` by score, all with
static shapes and validity masks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RPNConfig
from ..ops.box_coder import delta_decode, multilevel_anchors
from ..ops.nms import NEG_INF, nms
from .layers import Conv2d, nchw, nhwc

Tensor = torch.Tensor


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 cls/reg heads over each (NHWC) level."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[List[Tensor], List[Tensor]]:
        cls_scores, bbox_preds = [], []
        for f in feats:
            x = F.relu(self.rpn_conv(nchw(f)))
            cls_scores.append(nhwc(self.rpn_cls(x)))
            bbox_preds.append(nhwc(self.rpn_reg(x)))
        return cls_scores, bbox_preds


def _topk_stable(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Top-k along the last axis, ties to the lower index (lax.top_k)."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def get_proposals(
    cls_scores: Sequence[Tensor],    # per level (B, H, W, A) logits
    bbox_preds: Sequence[Tensor],    # per level (B, H, W, A*4)
    cfg: RPNConfig,
    img_shape: Tuple[int, int],      # static padded (H, W)
    nms_pre: int,
    nms_post: int,
    valid_shapes: Tensor | None = None,  # (B, 2) true (h, w) per image
) -> Tuple[Tensor, Tensor]:
    """Returns (proposals (B, nms_post, 4), valid (B, nms_post))."""
    B = cls_scores[0].shape[0]
    device = cls_scores[0].device
    feat_sizes = [(s.shape[1], s.shape[2]) for s in cls_scores]
    anchors = multilevel_anchors(
        feat_sizes, cfg.anchors.strides, cfg.anchors.scales,
        cfg.anchors.ratios, device,
    )

    all_props, all_pscores = [], []
    for score, pred, anc in zip(cls_scores, bbox_preds, anchors):
        s = score.reshape(B, -1)                       # (B, HWA) logits
        p = pred.reshape(B, -1, 4)
        k = min(nms_pre, s.shape[1])
        top_s, top_i = _topk_stable(s, k)
        top_anc = anc[top_i]                           # (B, k, 4)
        top_p = torch.gather(p, 1, top_i[..., None].expand(B, k, 4))
        boxes = delta_decode(
            top_anc, top_p, cfg.target_means, cfg.target_stds,
            max_shape=img_shape,
        )
        # degenerate-box filter
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        ok = (w > cfg.min_bbox_size) & (h > cfg.min_bbox_size)
        if valid_shapes is not None:
            # drop boxes that start inside the zero padding
            ok = ok & (boxes[..., 0] < valid_shapes[:, None, 1]) & (
                boxes[..., 1] < valid_shapes[:, None, 0]
            )
        top_s = torch.where(ok, top_s, torch.full_like(top_s, NEG_INF))
        max_out = min(nms_post, k)
        keep_idx, keep_valid = nms(
            boxes, top_s, cfg.nms_thr, max_out, exact=False, fixpoint_iters=16,
        )
        all_props.append(torch.gather(
            boxes, 1, keep_idx[..., None].expand(B, max_out, 4)
        ))
        kept_s = torch.gather(top_s, 1, keep_idx)
        all_pscores.append(
            torch.where(keep_valid, kept_s, torch.full_like(kept_s, NEG_INF))
        )

    boxes = torch.cat(all_props, dim=1)                # (B, sum(k_l), 4)
    scores = torch.cat(all_pscores, dim=1)
    top_s, top_i = _topk_stable(scores, min(nms_post, scores.shape[1]))
    props = torch.gather(boxes, 1, top_i[..., None].expand(top_i.shape + (4,)))
    return props, top_s > NEG_INF / 2
