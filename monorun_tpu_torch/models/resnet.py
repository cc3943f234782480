"""ResNet backbone with frozen BatchNorm (torchvision / mmdet layout), the
PyTorch counterpart of ``monorun_tpu/models/resnet.py``.

BatchNorm always normalises with its running statistics, so it is a
constant affine at run time; its parameters keep the reference names so a
reference checkpoint loads unchanged. The stem is the plain 7x7/stride-2
conv (the JAX package's space-to-depth rewrite of it is a TPU layout
trick with the same result).

Input and outputs are NHWC; the convolutions run NCHW channels_last.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, nchw, nhwc

STAGE_BLOCKS = {
    26: (1, 1, 1, 1),   # bottleneck mini-variant for CPU tests
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always normalises with running statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW
        std = torch.sqrt(self.running_var + self.eps)
        inv = self.weight / std
        shift = self.bias - self.running_mean * self.weight / std
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """torchvision-style bottleneck: stride on the 3x3 conv."""

    def __init__(self, cin: int, features: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.downsample = (
            nn.Sequential(
                Conv2d(cin, features * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm(features * 4),
            )
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """(B, H, W, 3) -> the four stage outputs (C2..C5), strides 4..32."""

    def __init__(self, depth: int = 101, out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin, features = 64, 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            stride = 1 if stage == 0 else 2
            blocks = []
            for i in range(n_blocks):
                blocks.append(Bottleneck(
                    cin, features, stride if i == 0 else 1, downsample=i == 0
                ))
                cin = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            features *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = nchw(x)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(nhwc(x))
        return tuple(outs)
