"""FPN with an extra high-resolution (stride-2) output, "FPNplus"; the
PyTorch counterpart of ``monorun_tpu/models/fpn.py``.

Standard FPN laterals with a nearest top-down pass (P2..P5), extra levels
by 1x1/stride-2 subsampling (P6), plus ``num_lower_outs`` finer levels: a
3x3 conv over the finest post-top-down lateral, either upsampled 2x
bilinearly first (the dense reference build, which a ``.pth`` load
selects) or left on its stride-4 grid (``lazy_lower``, the config
default, which the RoI aligns then sample at stride 4).

Output: (P1, P2, P3, P4, P5, P6) NHWC with strides (2, 4, 8, 16, 32, 64).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvModule, nchw, nhwc


class FPNplus(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int] = (256, 512, 1024, 2048),
        out_channels: int = 256,
        num_outs: int = 5,
        num_lower_outs: int = 1,
        lazy_lower: bool = False,
    ):
        super().__init__()
        self.num_outs = num_outs
        self.num_lower_outs = num_lower_outs
        self.lazy_lower = lazy_lower
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in in_channels
        )
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in in_channels
        )
        self.lower_fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in range(num_lower_outs)
        )

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [
            conv(nchw(x)) for conv, x in zip(self.lateral_convs, inputs)
        ]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode="nearest"
            )

        outs_lower = []
        for i, conv in enumerate(self.lower_fpn_convs):
            src = laterals[0]
            if not self.lazy_lower:
                # half-pixel bilinear == jax.image.resize "bilinear" for an
                # integer upscale, edges included (both clamp to the border)
                src = F.interpolate(
                    src, scale_factor=2 ** (self.num_lower_outs - i),
                    mode="bilinear", align_corners=False,
                )
            outs_lower.append(conv(src))

        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(nhwc(x) for x in outs_lower + outs)
