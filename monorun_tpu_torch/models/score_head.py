"""MLP score head predicting 3D localisation quality (inference), the
PyTorch counterpart of ``monorun_tpu/models/score_head.py``.

Input = [yaw(1), t(3), cov lower triangle(10), dims(3)] normalised by the
smooth BatchNorm's running statistics, one FC fused additively with the
global head's FC feature, one more FC, scalar logit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ScoreHeadConfig
from .layers import Linear

Tensor = torch.Tensor


class BatchNormSmooth(nn.Module):
    """Normaliser with EMA running statistics (used as-is at inference)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:
        out = (x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        return out * self.weight + self.bias


class ScoreHead(nn.Module):
    def __init__(self, cfg: ScoreHeadConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.pose_norm = BatchNormSmooth(17) if c.use_pose_norm else None
        self.pose_fcs = nn.ModuleList([Linear(17, c.pose_fc_out_channels)])
        self.fused_fcs = nn.ModuleList(
            [Linear(c.pose_fc_out_channels, c.fc_out_channels)]
        )
        self.fc_out = Linear(c.fc_out_channels, 1)

    def forward(self, reg_fc_out: Tensor, yaw: Tensor, t_vec: Tensor,
                pose_cov: Tensor, dimensions: Tensor) -> Tensor:
        """(n, F), (n, 1), (n, 3), (n, 4, 4), (n, 3) -> logits (n,) float32."""
        ix, iy = torch.tril_indices(4, 4, device=pose_cov.device)
        x = torch.cat([yaw, t_vec, pose_cov[:, ix, iy], dimensions], dim=1)
        if self.pose_norm is not None:
            x = self.pose_norm(x)
        dt = reg_fc_out.dtype
        x = F.relu(self.pose_fcs[0](x.to(dt)))
        x = x + reg_fc_out
        x = F.relu(self.fused_fcs[0](x))
        return self.fc_out(x)[:, 0].float()
