"""Multilevel aligned RoIAlign: the op layer of the port
(``monorun_tpu/ops/roi_align.py`` in PyTorch).

Semantics are mmcv's ``roi_align(..., 'avg', aligned=True)`` behind
mmdet's SingleRoIExtractor level mapping:

* each RoI goes to level floor(log2(sqrt(area) / finest_scale + 1e-6)),
  pushed coarser until its long side spans at most ``long_span_cap``
  cells of the finest level, and clamped to the pyramid;
* its coordinates are scaled to that level and shifted by -0.5;
* each output bin averages a ``ceil(bin)`` x ``ceil(bin)`` grid of
  bilinear samples (``sampling_ratio=0``), capped at ``max_ratio``;
* samples outside ``[-1, size]`` contribute zero, the others are clamped
  into the map, with the far tap clamped to the last row/column.

``multilevel_roi_align`` is the plain PyTorch version: a static
``max_ratio`` grid with per-RoI sample masks, four tap gathers per sample,
accumulated in float32. In this copy ``multilevel_roi_align_auto``, what
the detector calls, runs it on every device; its autograd gives the
gradients in the levels and in the RoIs.

Layout is channels-last: levels (B, H_l, W_l, C), output (n, oh, ow, C).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .clip import clip

Tensor = torch.Tensor

# long-side level cap (in finest-level cells) of every align on the
# serving path: the JAX package's TPU tile budget of 96 columns minus its
# 18-column snap/halo, which the dispatcher applies on every backend
LONG_SPAN_CAP = 96 - 18


def _div(x: Tensor, d: float) -> Tensor:
    """``x / d`` as one rounded division on every device. On CUDA a
    division by a Python scalar is a product with its reciprocal, which
    can round one ulp away; in the sample coordinates that ulp moves the
    bilinear weights enough to show in bfloat16 outputs, and in ``ceil``
    it can change a sample grid. The CUDA kernel divides."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def align_strides(lazy_lower: bool, strides: Sequence[int]) -> Tuple[int, ...]:
    """Sampling strides for the RoI aligns (``detector.py:_align_strides``).

    With the lazy FPN lower level the declared stride-2 level is physically
    a stride-4 map: level ASSIGNMENT is unchanged (it uses finest_scale
    only) and the sampling coordinates are taken at stride 4.
    """
    if lazy_lower and strides and strides[0] == 2:
        return (4,) + tuple(strides[1:])
    return tuple(strides)


def assign_fpn_levels(
    rois: Tensor,
    num_levels: int,
    finest_scale: float,
    long_span_cap: float | None = None,
    stride0: float | None = None,
) -> Tensor:
    """mmdet SingleRoIExtractor level mapping (int64, (n,)), plus the
    optional long-side cap in cells of the finest level."""
    w = (rois[:, 3] - rois[:, 1]).clamp(min=0)
    h = (rois[:, 4] - rois[:, 2]).clamp(min=0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(torch.log2(_div(scale, finest_scale) + 1e-6))
    if long_span_cap is not None:
        need = torch.ceil(torch.log2(
            _div(torch.maximum(w, h), long_span_cap * stride0).clamp(min=2.0 ** -20)
        ))
        lvl = torch.maximum(lvl, need)
    return lvl.clamp(0, num_levels - 1).long()


def _sample_grid(
    rois_xyxy: Tensor,      # (n, 4) in level coords (scaled and shifted)
    out_size: Tuple[int, int],
    max_ratio: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sample coordinates x, y (n, P) and averaging weights (n, P), with
    P = oh * ow * max_ratio^2 in (oh, ow, ky, kx) order; samples beyond a
    RoI's ``ceil(bin)`` grid get zero weight."""
    oh, ow = out_size
    n = rois_xyxy.shape[0]
    dev = rois_xyxy.device
    x1, y1, x2, y2 = rois_xyxy.unbind(1)
    roi_w = x2 - x1
    roi_h = y2 - y1
    bin_w = _div(roi_w, ow)
    bin_h = _div(roi_h, oh)
    gw = torch.ceil(bin_w).clamp(1, max_ratio).int()
    gh = torch.ceil(bin_h).clamp(1, max_ratio).int()
    gwf, ghf = gw.float(), gh.float()
    iy = torch.arange(oh, device=dev, dtype=torch.float32)
    ix = torch.arange(ow, device=dev, dtype=torch.float32)
    k = torch.arange(max_ratio, device=dev, dtype=torch.float32)

    ys = (
        y1[:, None, None]
        + iy[None, :, None] * bin_h[:, None, None]
        + (k[None, None, :] + 0.5) * bin_h[:, None, None] / ghf[:, None, None]
    )                                                   # (n, oh, ky)
    xs = (
        x1[:, None, None]
        + ix[None, :, None] * bin_w[:, None, None]
        + (k[None, None, :] + 0.5) * bin_w[:, None, None] / gwf[:, None, None]
    )                                                   # (n, ow, kx)
    my = (k[None, None, :] < ghf[:, None, None]).float()
    mx = (k[None, None, :] < gwf[:, None, None]).float()

    shape = (n, oh, ow, max_ratio, max_ratio)
    yy = ys[:, :, None, :, None].expand(shape)
    xx = xs[:, None, :, None, :].expand(shape)
    mm = (my[:, :, None, :, None] * mx[:, None, :, None, :]).expand(shape)
    avg_w = mm / (gh * gw).float()[:, None, None, None, None]
    P = oh * ow * max_ratio * max_ratio
    return xx.reshape(n, P), yy.reshape(n, P), avg_w.reshape(n, P)


def sample_taps(
    sizes: Sequence[Tuple[int, int]],   # per level (H_l, W_l)
    rois: Tensor,                       # (m, 5) float32
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float,
    max_ratio: int,
    long_span_cap: float | None = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The bilinear taps of every sample, on the pyramid flattened to rows
    of C channels (batch-major, then level, then row-major pixels).

    Returns the tap rows (4, m, P), their weights (4, m, P) with the
    validity rule folded in, and the bin-averaging weights (m, P), with
    P = oh * ow * max_ratio^2 as in ``_sample_grid``."""
    dev = rois.device
    offsets, total = [], 0
    for h, w in sizes:
        offsets.append(total)
        total += h * w
    stride_arr = torch.tensor([float(s) for s in strides], device=dev)
    h_arr = torch.tensor([h for h, _ in sizes], device=dev)
    w_arr = torch.tensor([w for _, w in sizes], device=dev)
    off_arr = torch.tensor(offsets, device=dev)

    lvls = assign_fpn_levels(rois, len(sizes), finest_scale, long_span_cap,
                             float(strides[0]))
    Hn = h_arr[lvls][:, None]
    Wn = w_arr[lvls][:, None]
    boxes = rois[:, 1:5] * (1.0 / stride_arr[lvls])[:, None] - 0.5
    xs, ys, avg_w = _sample_grid(boxes, out_size, max_ratio)

    valid = (ys >= -1.0) & (ys <= Hn) & (xs >= -1.0) & (xs <= Wn)
    y = clip(ys, 0.0, (Hn - 1).float())
    x = clip(xs, 0.0, (Wn - 1).float())
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.minimum(y0i + 1, Hn - 1)
    x1i = torch.minimum(x0i + 1, Wn - 1)

    base = (rois[:, 0].long() * total + off_arr[lvls])[:, None]
    rows = torch.stack([
        base + y0i * Wn + x0i, base + y0i * Wn + x1i,
        base + y1i * Wn + x0i, base + y1i * Wn + x1i,
    ])
    weights = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx]) * valid
    return rows, weights, avg_w


def multilevel_roi_align(
    features: Sequence[Tensor],   # per level (B, H_l, W_l, C)
    rois: Tensor,                 # (n, 5) [batch, x1, y1, x2, y2] image coords
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float = 56.0,
    max_ratio: int = 4,
    chunk_size: int = 512,
    long_span_cap: float | None = None,
) -> Tensor:
    """Plain FPN RoIAlign by gathers over one flattened pyramid; the
    reference that the CUDA kernel is held to. RoIs go in ``chunk_size``
    blocks so the (chunk, samples, C) gathers stay bounded.
    Returns (n, oh, ow, C) in the features' dtype."""
    assert len(features) == len(strides)
    B = features[0].shape[0]
    C = features[0].shape[-1]
    oh, ow = out_size
    n = rois.shape[0]
    fdtype = features[0].dtype
    sizes = [(f.shape[1], f.shape[2]) for f in features]
    pyramid = torch.cat([f.reshape(B, -1, C) for f in features], dim=1).reshape(-1, C)

    out = torch.empty((n, oh, ow, C), dtype=fdtype, device=rois.device)
    for start in range(0, n, chunk_size):
        rc = rois[start:start + chunk_size].float()
        m = rc.shape[0]
        rows, weights, avg_w = sample_taps(
            sizes, rc, strides, out_size, finest_scale, max_ratio, long_span_cap,
        )
        acc = None
        for idx, wgt in zip(rows, weights):
            g = pyramid[idx].float() * wgt[..., None]
            acc = g if acc is None else acc + g
        acc = acc * avg_w[..., None]
        out[start:start + m] = acc.reshape(m, oh, ow, max_ratio ** 2, C).sum(3).to(fdtype)
    return out


def prepare_pyramid(features: Sequence[Tensor]):
    """No staged kernel here: nothing to prepare."""
    return None


def multilevel_roi_align_auto(
    features: Sequence[Tensor],
    rois: Tensor,
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float,
    max_ratio: int = 3,
    tile_h: int = 24,
    pyramid=None,
) -> Tensor:
    """The plain gather version on every device."""
    return multilevel_roi_align(
        features, rois, strides, out_size, finest_scale,
        max_ratio=max_ratio, long_span_cap=LONG_SPAN_CAP,
    )


def roi_grid_centers(rois: Tensor, out_size: Tuple[int, int]) -> Tensor:
    """Analytic aligned RoIAlign of the pixel-coordinate field: the average
    of a linear field over a symmetric sample grid is its value at the bin
    centre. Returns (n, oh, ow, 2) [u, v]."""
    oh, ow = out_size
    x1 = rois[:, 1] - 0.5
    y1 = rois[:, 2] - 0.5
    bw = (rois[:, 3] - rois[:, 1]) / ow
    bh = (rois[:, 4] - rois[:, 2]) / oh
    jj = torch.arange(ow, dtype=rois.dtype, device=rois.device)
    ii = torch.arange(oh, dtype=rois.dtype, device=rois.device)
    u = x1[:, None] + (jj[None, :] + 0.5) * bw[:, None]     # (n, ow)
    v = y1[:, None] + (ii[None, :] + 0.5) * bh[:, None]     # (n, oh)
    n = rois.shape[0]
    uu = u[:, None, :].expand(n, oh, ow)
    vv = v[:, :, None].expand(n, oh, ow)
    return torch.stack([uu, vv], -1)
