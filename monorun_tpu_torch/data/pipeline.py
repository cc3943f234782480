"""On-device test-time preprocessing, the PyTorch counterpart of
``monorun_tpu/data/pipeline.py:device_preprocess`` and
``scale_intrinsics``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import DataConfig

Tensor = torch.Tensor


def device_preprocess(raw: Tensor, shapes: Tensor, data_cfg: DataConfig
                      ) -> Tuple[Tensor, Tensor]:
    """uint8 canvas -> normalised, padded float32 batch.

    ``raw``: (B, raw_height, raw_width, 3) uint8 (or float), each image
    pasted top-left at native resolution. ``shapes``: (B, 2) native (h, w).
    Returns the (B, pad_height, pad_width, 3) batch, zero outside each
    image, and (h, w) * test_scale. With test_scale != 1 the whole canvas
    is resized first (half-pixel bilinear, no antialiasing).
    """
    x = raw.float()
    s = float(data_cfg.test_scale)
    shapes = shapes.float()
    if s != 1.0:
        nh = int(round(raw.shape[1] * s))
        nw = int(round(raw.shape[2] * s))
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
            align_corners=False, antialias=False,
        ).permute(0, 2, 3, 1)
        shapes = torch.round(shapes * s)
    ph, pw = data_cfg.pad_height, data_cfg.pad_width
    x = x[:, :ph, :pw]
    x = F.pad(x, (0, 0, 0, pw - x.shape[2], 0, ph - x.shape[1]))
    mean = torch.tensor(data_cfg.img_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(data_cfg.img_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    # padding is 0 in NORMALISED space
    rows = torch.arange(ph, dtype=torch.float32, device=x.device)[None, :, None, None]
    cols = torch.arange(pw, dtype=torch.float32, device=x.device)[None, None, :, None]
    valid = (rows < shapes[:, 0, None, None, None]) & (
        cols < shapes[:, 1, None, None, None]
    )
    return torch.where(valid, x, torch.zeros_like(x)), shapes


def scale_intrinsics(cam: Tensor, test_scale: float) -> Tensor:
    """K for the resized image: focal lengths and principal point x s."""
    if float(test_scale) == 1.0:
        return cam
    scale = torch.tensor([[test_scale], [test_scale], [1.0]],
                         dtype=torch.float32, device=cam.device)
    return cam.float() * scale
