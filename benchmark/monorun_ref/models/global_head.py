"""Global 3D head: per-RoI dimensions and latent vector with Monte-Carlo
dropout, the PyTorch counterpart of ``monorun_tpu/models/global_head.py``.

The reference replicates every RoI 50x through always-on dropout. As in
the JAX package the sampling is factored: channel dropout commutes with
the first FC, so with per-channel masks m and per-channel partial
products P[n, c] = sum_hw x[n, h, w, c] * W1[c, hw, :] the pre-activation
of sample s is sum_c m[s, n, c] * P[n, c]; one fc1 pass plus a small
(S, C) x (C, F) product per RoI replaces 50 fc1 passes.

The masks are inputs: ``forward(..., masks=(m2d, m0, m1))`` takes the
pre-scaled {0, 1/keep} masks of the channel dropout (n, S, C) and of the
two FC dropouts (n, S, F); without them they are drawn from ``generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import GlobalHeadConfig
from .layers import Linear

Tensor = torch.Tensor


class GlobalHeadOutput(NamedTuple):
    dim_latent_pred: Tensor           # (n, (3+L)*K) or (n, 3+L)
    dim_latent_var: Optional[Tensor]
    reg_fc_out: Tensor                # (n, F)


def mc_dropout_masks(
    cfg: GlobalHeadConfig, n: int, dtype: torch.dtype, device,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pre-scaled Bernoulli masks (m2d (n, S, C), m0, m1 (n, S, F))."""
    S, C, Fo = cfg.mc_samples, cfg.in_channels, cfg.fc_out_channels

    def draw(shape, keep):
        u = torch.rand(shape, generator=generator, device=device)
        return torch.where(u < keep, 1.0 / keep, 0.0).to(dtype)

    keep2d = 1.0 - cfg.dropout2d_rate
    keep = 1.0 - cfg.dropout_rate
    return draw((n, S, C), keep2d), draw((n, S, Fo), keep), draw((n, S, Fo), keep)


class GlobalHead(nn.Module):
    def __init__(self, cfg: GlobalHeadConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        area = c.roi_feat_size * c.roi_feat_size
        per = 3 + c.latent_channels
        out_dim = per if c.latent_class_agnostic else per * c.num_classes
        self.fcs = nn.ModuleList([
            Linear(c.in_channels * area, c.fc_out_channels),
            Linear(c.fc_out_channels, c.fc_out_channels),
        ])
        self.fc_reg = Linear(c.fc_out_channels, out_dim)

    def forward(
        self,
        roi_feats: Tensor,                                  # (n, 7, 7, C)
        masks: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> GlobalHeadOutput:
        n, fh, fw, ch = roi_feats.shape
        dt = roi_feats.dtype
        if masks is None:
            masks = mc_dropout_masks(self.cfg, n, dt, roi_feats.device, generator)
        m2d, m0, m1 = (m.to(dt) for m in masks)

        fc0, fc1 = self.fcs
        k0 = fc0.weight.to(dt).view(-1, ch, fh * fw)         # (F, C, area)
        xt = roi_feats.permute(0, 3, 1, 2).reshape(n, ch, fh * fw)
        P = torch.einsum("nca,fca->ncf", xt, k0)             # (n, C, F)
        h = F.relu(torch.bmm(m2d, P) + fc0.bias.to(dt))      # (n, S, F)
        h = h * m0
        h = F.relu(fc1(h)) * m1
        out = self.fc_reg(h).float()                         # (n, S, D)
        return GlobalHeadOutput(
            out.mean(1), out.var(1, unbiased=True), h.mean(1).float()
        )


def slice_pred(
    cfg: GlobalHeadConfig,
    dim_latent_pred: Tensor,
    dim_latent_var: Optional[Tensor],
    labels: Tensor,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Optional[Tensor]]:
    """Pick each RoI's per-class (3+L) block: (dim, dim_var, latent,
    latent_var)."""
    per = 3 + cfg.latent_channels

    def pick(arr):
        if arr is None or cfg.latent_class_agnostic:
            return arr
        r = arr.reshape(arr.shape[0], -1, per)
        return r[torch.arange(r.shape[0], device=r.device), labels]

    p = pick(dim_latent_pred)
    v = pick(dim_latent_var)
    dim, latent = p[:, :3], p[:, 3:]
    if v is None:
        return dim, None, latent, None
    return dim, v[:, :3], latent, v[:, 3:]
