"""Conv and linear layers that run in the dtype of their input.

Serving casts the >= 2-D weights to the compute dtype once
(``apis/inference.py``) and keeps biases and normalisation statistics in
float32, as the JAX package does; these layers cast what is left at use,
which is a no-op for weights already in the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(
            x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.dilation, self.groups,
        )


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm or activation: the ``.conv`` level
    in the reference key names (``neck.fpn_convs.0.conv.weight``)."""

    def __init__(self, cin: int, cout: int, k: int, padding: int = 0):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC view -> NCHW tensor (channels_last in memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC view (contiguous if x was channels_last)."""
    return x.permute(0, 2, 3, 1)
