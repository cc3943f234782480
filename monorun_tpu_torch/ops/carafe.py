"""CARAFE content-aware upsampling (mmcv ``CARAFEPack``), the PyTorch
counterpart of ``monorun_tpu/ops/carafe.py``.

1. a 1x1 conv compresses channels,
2. a 3x3 conv predicts ``scale^2 * k_up^2`` reassembly kernels per input
   position, softmax-normalised over the k_up^2 window,
3. each upsampled output pixel is the kernel-weighted sum of the
   k_up x k_up input neighbourhood (zero padded) around its source pixel.

Public layout is NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, nchw, nhwc

Tensor = torch.Tensor


def carafe(features: Tensor, kernels: Tensor, k_up: int, scale: int) -> Tensor:
    """Reassembly: features (N, H, W, C), kernels (N, H, W, s*s, k*k) with
    taps (ky-major, kx) -> (N, s*H, s*W, C)."""
    n, h, w, c = features.shape
    s, k2 = scale, k_up * k_up
    patches = F.unfold(nchw(features), k_up, padding=k_up // 2)   # (N, C*k2, HW)
    patches = patches.reshape(n, c, k2, h, w)
    kern = kernels.reshape(n, h, w, s, s, k2).to(features.dtype)
    out = torch.einsum("nhwabk,nckhw->nhawbc", kern, patches)
    return out.reshape(n, h * s, w * s, c)


class CARAFEPack(nn.Module):
    def __init__(self, channels: int, scale: int = 2, up_kernel: int = 5,
                 encoder_kernel: int = 3, compressed_channels: int = 64):
        super().__init__()
        self.scale = scale
        self.up_kernel = up_kernel
        self.channel_compressor = Conv2d(channels, compressed_channels, 1)
        self.content_encoder = Conv2d(
            compressed_channels, scale * scale * up_kernel * up_kernel,
            encoder_kernel, padding=(encoder_kernel - 1) // 2,
        )

    def forward(self, x: Tensor) -> Tensor:                 # NHWC
        enc = nhwc(self.content_encoder(self.channel_compressor(nchw(x))))
        n, h, w, _ = enc.shape
        k2 = self.up_kernel * self.up_kernel
        s2 = self.scale * self.scale
        # mmcv pixel-shuffles (s2*k2) k2-major: [k2, sy, sx]
        kern = enc.reshape(n, h, w, k2, s2).transpose(-1, -2)  # (N, H, W, s2, k2)
        kern = torch.softmax(kern, dim=-1)
        return carafe(x, kern, self.up_kernel, self.scale)
