"""Dense NOC decoder (inference): 14x14 RoI features -> 28x28 NOC map and
aleatoric log-std; the PyTorch counterpart of
``monorun_tpu/models/noc_head.py``.

Three 3x3 convs, additive latent-vector injection through a linear layer,
CARAFE 2x upsampling, one post-upsample conv, and a final 1x1 conv whose
output holds, per flip bank, the class-major NOC channels (3 per class)
then the log-std channels (2 per class); each RoI reads the bank of its
flip flag and the block of its label.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import NOCHeadConfig
from ..ops.carafe import CARAFEPack
from .layers import Conv2d, ConvModule, Linear, nchw, nhwc

Tensor = torch.Tensor


class NOCHeadOutput(NamedTuple):
    noc_pred: Tensor       # (n, 28, 28, 3)
    proj_logstd: Tensor    # (n, 28, 28, 2)


class NOCHead(nn.Module):
    def __init__(self, cfg: NOCHeadConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.convs = nn.ModuleList(
            ConvModule(c.in_channels if i == 0 else c.conv_out_channels,
                       c.conv_out_channels, 3, padding=1)
            for i in range(c.num_convs)
        )
        self.latent_decoder = Linear(c.latent_channels, c.conv_out_channels)
        self.upsample = None
        self.convs_upsampled = nn.ModuleList()
        if c.dense_size > c.roi_size:
            self.upsample = CARAFEPack(
                c.conv_out_channels, scale=2, up_kernel=c.carafe_up_kernel,
                encoder_kernel=c.carafe_encoder_kernel,
                compressed_channels=c.carafe_compressed_channels,
            )
            self.convs_upsampled = nn.ModuleList(
                ConvModule(c.conv_out_channels, c.conv_out_channels, 3, padding=1)
                for _ in range(c.num_convs_upsampled)
            )
        ncls = 1 if c.class_agnostic else c.num_classes
        nb = 2 if c.flip_correction else 1
        self.conv_final = Conv2d(
            c.conv_out_channels, (c.noc_channels + c.uncert_channels) * ncls * nb, 1
        )

    def forward(
        self,
        roi_feats: Tensor,     # (n, 14, 14, C)
        latent: Tensor,        # (n, L)
        labels: Tensor,        # (n,) int
        flip: Tensor,          # (n,) bool
    ) -> NOCHeadOutput:
        c = self.cfg
        n = roi_feats.shape[0]
        x = nchw(roi_feats)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x + self.latent_decoder(latent.to(x.dtype))[:, :, None, None]
        if self.upsample is not None:
            x = nchw(self.upsample(nhwc(x)))
            for conv in self.convs_upsampled:
                x = F.relu(conv(x))

        out = nhwc(self.conv_final(x))                 # (n, h, w, banks*per)
        ncls = 1 if c.class_agnostic else c.num_classes
        nb = 2 if c.flip_correction else 1
        nc_ch, std_ch = c.noc_channels, c.uncert_channels
        out = out.reshape(out.shape[:3] + (nb, (nc_ch + std_ch) * ncls))
        rows = torch.arange(n, device=out.device)
        bank = flip.long() * (nb - 1)
        cls = torch.zeros_like(labels) if c.class_agnostic else labels.long()
        sel = out.permute(0, 3, 4, 1, 2)[rows, bank]   # (n, per, h, w)
        noc_idx = cls[:, None] * nc_ch + torch.arange(nc_ch, device=out.device)
        std_idx = (ncls * nc_ch + cls[:, None] * std_ch
                   + torch.arange(std_ch, device=out.device))
        noc = sel[rows[:, None], noc_idx]              # (n, 3, h, w)
        logstd = sel[rows[:, None], std_idx]           # (n, 2, h, w)
        return NOCHeadOutput(
            noc.permute(0, 2, 3, 1).float(), logstd.permute(0, 2, 3, 1).float()
        )
