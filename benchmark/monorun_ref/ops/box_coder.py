"""DeltaXYWH box codec and anchor generation (mmdet semantics), the
PyTorch counterpart of ``monorun_tpu/ops/box_coder.py``."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Tensor = torch.Tensor


def _xyxy_to_cxcywh(boxes: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return cx, cy, w, h


def _vec(values: Sequence[float], like: Tensor) -> Tensor:
    # float32 like the JAX package's jnp.asarray(means): promotes bf16
    # network outputs to float32 box arithmetic
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def delta_decode(
    proposals: Tensor,     # (..., 4) xyxy
    deltas: Tensor,        # (..., 4)
    means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
    stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    max_shape: Tuple[int, int] | None = None,   # (H, W) clip
    wh_ratio_clip: float = 16.0 / 1000.0,
) -> Tensor:
    d = deltas * _vec(stds, deltas) + _vec(means, deltas)
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    px, py, pw, ph = _xyxy_to_cxcywh(proposals)
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    boxes = torch.stack(
        [gx - 0.5 * gw, gy - 0.5 * gh, gx + 0.5 * gw, gy + 0.5 * gh], -1
    )
    if max_shape is not None:
        h, w = max_shape
        boxes = torch.stack(
            [
                boxes[..., 0].clamp(0, w),
                boxes[..., 1].clamp(0, h),
                boxes[..., 2].clamp(0, w),
                boxes[..., 3].clamp(0, h),
            ],
            -1,
        )
    return boxes


def base_anchors(
    base_size: float, scales: Sequence[float], ratios: Sequence[float],
    device: torch.device | str = "cpu",
) -> Tensor:
    """(num_ratios * num_scales, 4) xyxy anchors centred at the origin,
    ratio-major like mmdet's AnchorGenerator."""
    anchors = []
    for r in ratios:
        for s in scales:
            w = base_size * s * math.sqrt(1.0 / r)
            h = base_size * s * math.sqrt(r)
            anchors.append([-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h])
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def grid_anchors(
    feat_size: Tuple[int, int],
    stride: int,
    scales: Sequence[float],
    ratios: Sequence[float],
    device: torch.device | str = "cpu",
) -> Tensor:
    """All anchors of one level: (H * W * A, 4), row-major, anchor-minor."""
    base = base_anchors(float(stride), scales, ratios, device)    # (A, 4)
    fh, fw = feat_size
    xs = torch.arange(fw, device=device, dtype=torch.float32) * stride
    ys = torch.arange(fh, device=device, dtype=torch.float32) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    shift = torch.stack([xx, yy, xx, yy], -1).reshape(fh * fw, 1, 4)
    return (shift + base[None]).reshape(fh * fw * base.shape[0], 4)


def multilevel_anchors(
    feat_sizes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    scales: Sequence[float],
    ratios: Sequence[float],
    device: torch.device | str = "cpu",
) -> List[Tensor]:
    return [
        grid_anchors(fs, st, scales, ratios, device)
        for fs, st in zip(feat_sizes, strides)
    ]
