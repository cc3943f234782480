"""MLP score head predicting 3D localisation quality, the PyTorch
counterpart of ``monorun_tpu/models/score_head.py``.

Input = [yaw(1), t(3), cov lower triangle(10), dims(3)], without gradient,
normalised by the smooth BatchNorm's running statistics, one FC fused
additively with the global head's FC feature, one more FC, scalar logit.
In training the smooth BatchNorm first moves its running statistics
towards the valid rows' moments (an EMA), then normalises with them.
``score_targets`` and ``iou3d_balanced_sample_weights`` give the score
loss its targets and its sampling weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ScoreHeadConfig
from ..ops.clip import clip
from ..parallel import global_sum
from .layers import Linear

Tensor = torch.Tensor


class BatchNormSmooth(nn.Module):
    """Normaliser that uses its EMA running statistics in training too."""

    def __init__(self, features: int, momentum: float = 0.01, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor, train: bool = False,
                valid: Optional[Tensor] = None) -> Tensor:
        if train:
            # moments over the valid rows only (the reference only sees
            # real RoIs), unbiased; no update from a single row. Over the
            # data-parallel ranks' rows: the global mean first, then the
            # deviations from it (JAX's two passes over the global batch)
            with torch.no_grad():
                xd = x.detach()
                w = (torch.ones(xd.shape[0], dtype=xd.dtype, device=xd.device)
                     if valid is None else valid.to(xd.dtype))
                n = global_sum(w.sum())
                m = global_sum((xd * w[:, None]).sum(0)) / clip(n, 1.0)
                v = global_sum((w[:, None] * (xd - m) ** 2).sum(0)) / clip(n - 1.0, 1.0)
                mom = self.momentum * (n > 1).to(xd.dtype)
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * m)
                self.running_var.copy_((1 - mom) * self.running_var + mom * v)
        out = (x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        return out * self.weight + self.bias


class ScoreHead(nn.Module):
    def __init__(self, cfg: ScoreHeadConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.pose_norm = (BatchNormSmooth(17, c.pose_norm_momentum)
                          if c.use_pose_norm else None)
        self.pose_fcs = nn.ModuleList([Linear(17, c.pose_fc_out_channels)])
        self.fused_fcs = nn.ModuleList(
            [Linear(c.pose_fc_out_channels, c.fc_out_channels)]
        )
        self.fc_out = Linear(c.fc_out_channels, 1)

    def forward(self, reg_fc_out: Tensor, yaw: Tensor, t_vec: Tensor,
                pose_cov: Tensor, dimensions: Tensor, train: bool = False,
                valid: Optional[Tensor] = None) -> Tensor:
        """(n, F), (n, 1), (n, 3), (n, 4, 4), (n, 3) -> logits (n,) float32
        (float64 in a float64 head); ``valid`` (n,) keeps padded rows out
        of the statistics' update and zeroes their inputs."""
        ix, iy = torch.tril_indices(4, 4, device=pose_cov.device)
        x = torch.cat([yaw, t_vec, pose_cov[:, ix, iy], dimensions], dim=1).detach()
        if valid is not None:
            x = torch.where(valid[:, None], x, torch.zeros_like(x))
        if self.pose_norm is not None:
            x = self.pose_norm(x, train, valid)
        dt = reg_fc_out.dtype
        x = F.relu(self.pose_fcs[0](x.to(dt)))
        x = x + reg_fc_out
        x = F.relu(self.fused_fcs[0](x))
        logits = self.fc_out(x)[:, 0]
        return logits.to(torch.promote_types(logits.dtype, torch.float32))


def score_targets(cfg: ScoreHeadConfig, ious: Tensor) -> Tensor:
    """3D IoU -> the score's soft BCE target."""
    if cfg.mode == "thres":
        return (ious >= cfg.iou_thres).float()
    if cfg.mode == "linear_average":
        return clip(cfg.linear_coefs[0] + ious * cfg.linear_coefs[1], 0.0, 1.0)
    return ious


def iou3d_balanced_sample_weights(
    cfg: ScoreHeadConfig, ious: Tensor, uniform: Tensor,
    valid: Optional[Tensor] = None,
) -> Tensor:
    """Random keep mask (as float weights) balancing the positive and
    negative score targets, with a smooth keep-rate ramp between the strong
    negative and strong positive IoUs; counts come from the valid rows, and
    invalid rows get 0. ``uniform`` (same shape as ``ious``) is the draw.
    The counts are the global batch's (summed over the data-parallel
    ranks)."""
    thr = cfg.sampler_pos_iou_thr
    fmin, fmax = cfg.sampler_pos_fraction_min, cfg.sampler_pos_fraction_max
    vmask = torch.ones_like(ious, dtype=torch.bool) if valid is None else valid.bool()
    num_total = global_sum(vmask.sum().float())
    pos = (ious >= thr) & vmask
    num_pos = global_sum(pos.sum().float())
    num_neg = num_total - num_pos
    num_pos_max = fmax / (1 - fmax) * num_neg
    num_neg_max = (1 - fmin) / fmin * num_pos
    one = torch.ones((), device=ious.device)

    balanced = (num_pos <= num_pos_max) & (num_neg <= num_neg_max)
    pos_keep = torch.where(num_pos > num_pos_max, num_pos_max / clip(num_pos, 1), one)
    neg_keep = torch.where(num_pos > num_pos_max, one, num_neg_max / clip(num_neg, 1))
    if cfg.sampler_smooth_keeprate:
        strong_pos = (thr + 1.0) / 2.0
        strong_neg = thr / 2.0
        keeprate = (pos_keep - neg_keep) / (strong_pos - strong_neg) * (
            ious - strong_neg) + neg_keep
    else:
        keeprate = torch.where(pos, pos_keep, neg_keep)
    keeprate = torch.where(balanced, one, keeprate)
    return ((uniform < keeprate) & vmask).float()
