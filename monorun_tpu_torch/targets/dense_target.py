"""Sparse NOC supervision targets by direct binning, the PyTorch
counterpart of ``monorun_tpu/targets/dense_target.py``.

Each object's sparse LiDAR object-coordinate points are encoded point by
point (the encoding commutes with the average) and binned straight into
their RoI's S x S grid by a scatter-add; a bin's target is the mean of its
points, its weight its occupancy normalised to mean one. The targets are
steps of the RoI boxes and carry no gradient.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.clip import clip

Tensor = torch.Tensor


def encode_noc_points(
    oc: Tensor,            # (..., 3) object-frame coords
    dims: Tensor,          # (..., 3) broadcastable
    flip: Tensor,          # (...,) bool broadcastable
    means: Sequence[float],
    stds: Sequence[float],
    eps: float = 1e-5,
) -> Tensor:
    """Point-wise NOC encoding (the coord coder, no mask weighting)."""
    parts = oc / clip(dims, eps)
    sign = torch.where(flip[..., None], -1.0, 1.0).to(parts.dtype)
    parts = parts * torch.cat([torch.ones_like(parts[..., :2]),
                               sign * torch.ones_like(parts[..., 2:])], -1)
    m = torch.as_tensor(means, dtype=parts.dtype, device=parts.device)
    s = torch.as_tensor(stds, dtype=parts.dtype, device=parts.device)
    return (parts - m) / s


def sparse_noc_targets(
    pos_rois: Tensor,       # (P, 4) xyxy (image coords)
    pos_valid: Tensor,      # (P,)
    pos_gt_inds: Tensor,    # (P,) index into the GT axis
    uv: Tensor,             # (G, Q, 2) sparse pixel coords per GT
    oc_enc: Tensor,         # (G, Q, 3) encoded NOC values per point
    pts_valid: Tensor,      # (G, Q)
    dense_size: int,
    eps: float = 1e-4,
) -> Tuple[Tensor, Tensor]:
    """Returns (targets (P, S, S, 3), weights (P, S, S, 1)), one image."""
    pos_rois = pos_rois.detach()
    P, S, Q = pos_rois.shape[0], dense_size, uv.shape[1]
    roi_uv = uv[pos_gt_inds]                        # (P, Q, 2)
    roi_oc = oc_enc[pos_gt_inds]                    # (P, Q, 3)
    roi_ok = pts_valid[pos_gt_inds] & pos_valid[:, None]

    x1 = pos_rois[:, 0:1]
    y1 = pos_rois[:, 1:2]
    bw = clip((pos_rois[:, 2:3] - x1) / S, 1e-3)
    bh = clip((pos_rois[:, 3:4] - y1) / S, 1e-3)
    bx = torch.floor((roi_uv[..., 0] - x1) / bw).long()
    by = torch.floor((roi_uv[..., 1] - y1) / bh).long()
    inside = (bx >= 0) & (bx < S) & (by >= 0) & (by < S) & roi_ok

    roi_idx = torch.arange(P, device=pos_rois.device)[:, None]
    seg = torch.where(inside, roi_idx * (S * S) + by * S + bx, P * S * S)  # dump slot
    flat_seg = seg.reshape(P * Q)
    flat_oc = torch.where(inside[..., None], roi_oc, 0.0).reshape(P * Q, 3)
    ones = inside.to(flat_oc.dtype).reshape(P * Q)
    sums = flat_oc.new_zeros(P * S * S + 1, 3).index_add_(0, flat_seg, flat_oc)
    counts = ones.new_zeros(P * S * S + 1).index_add_(0, flat_seg, ones)
    sums = sums[:-1].reshape(P, S, S, 3)
    counts = counts[:-1].reshape(P, S, S, 1)

    targets = sums / clip(counts, 1.0)
    weights = (counts > 0).to(targets.dtype)
    weights = weights / clip(weights.mean(), eps)
    return targets, weights
