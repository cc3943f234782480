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
accumulated in float32. ``multilevel_roi_align_tiled`` is the plain
separable version (``out = Y @ tile @ X^T`` with per-RoI interpolation
matrices from ``axis_interp_matrix``), the arithmetic of the staged
kernels (``roi_align_tile.py``, ``roi_align_band.py``).

``multilevel_roi_align_auto`` is what the detector calls. It reads
``MONORUN_ALIGN_IMPL`` (``auto | gather | sorted | band | bandmm``) and
the ``MONORUN_BAND_*`` switches as the JAX package's dispatcher does
(``align_choice``). On CUDA tensors it launches a hand-written kernel
(``roi_align_cuda.py``) and raises if it cannot; on CPU tensors every
setting runs the plain gather version. Gradients: the plain version's
autograd gives those of ``jax.grad`` through the JAX function, in the
levels and in the RoIs; the direct kernel (the ``kernel`` route) has its
own backward kernel (``roi_align_cuda.roi_align_direct``); the staged
kernels are forward-only and refuse inputs that require grad
(``refuse_grad``).

Layout is channels-last: levels (B, H_l, W_l, C), output (n, oh, ow, C).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

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


def refuse_grad(route: str, features: Sequence[Tensor], rois: Tensor) -> None:
    """Raise if autograd would need a gradient through a forward-only
    kernel route: grad is enabled and a level or the RoIs require it."""
    if torch.is_grad_enabled() and (
            rois.requires_grad or any(f.requires_grad for f in features)):
        raise RuntimeError(
            f"the {route} RoIAlign route has no backward: run it without grad "
            "(torch.no_grad or inference_mode) or use the direct kernel "
            "(MONORUN_ALIGN_IMPL=auto or sorted), which has one")


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


class BinTaps(NamedTuple):
    """The merged taps of every output bin (``merged_bin_taps``). A bin
    (i, j) of RoI n is ``sum_a sum_b (row_w[n, i, a] * col_w[n, j, b]) *
    F[base[n] + rows[n, i, a] * width[n] + cols[n, j, b]]`` on the
    flattened pyramid; entries that are not on a list have weight 0."""

    base: Tensor    # (m,) flat row of the RoI's image and level
    width: Tensor   # (m,) its level's width
    rows: Tensor    # (m, oh, 2 * max_ratio) tap rows, near and far per sample
    row_w: Tensor   # (m, oh, 2 * max_ratio) merged weights, times 1/(gh*gw)
    cols: Tensor    # (m, ow, 2 * max_ratio)
    col_w: Tensor   # (m, ow, 2 * max_ratio)


def _merge_axis(coords: Tensor, count: Tensor, size: Tensor) -> Tuple[Tensor, Tensor]:
    """One axis of ``merged_bin_taps``: coords (m, o, R) sample positions,
    count (m,) samples in use, size (m,) the level's extent. Returns the
    taps (m, o, 2R) in order (near, far of sample 0, near, far of sample
    1, ...) and their merged weights."""
    R = coords.shape[-1]
    k = torch.arange(R, device=coords.device)
    live = k < count[:, None, None]
    sizef = size.float()[:, None, None]
    valid = live & (coords >= -1.0) & (coords <= sizef)
    c = torch.minimum(coords.clamp(min=0.0), sizef - 1.0)
    f = torch.floor(c)
    lo = c - f
    t0 = f.long()
    t1 = torch.minimum(t0 + 1, size.long()[:, None, None] - 1)
    zero = torch.zeros_like(lo)
    taps = torch.stack([t0, t1], -1).flatten(-2)
    w = torch.stack([torch.where(valid, 1.0 - lo, zero),
                     torch.where(valid, lo, zero)], -1).flatten(-2)
    live2 = live.repeat_interleave(2, -1)
    # a far tap clamped onto its near tap merges into it
    owner = live2 & torch.cat([torch.ones_like(t0, dtype=torch.bool)[..., None],
                               (t1 != t0)[..., None]], -1).flatten(-2)
    later = torch.arange(2 * R, device=coords.device)
    sums = torch.zeros_like(w)
    for t in range(2 * R):
        match = (taps == taps[..., t:t + 1]) & live2[..., t:t + 1]
        sums = sums + torch.where(match, w[..., t:t + 1], 0.0)
        owner = owner & ~(match & (later > t))
    owner = owner & (sums != 0)
    return taps, torch.where(owner, sums, 0.0)


def merged_bin_taps(
    sizes: Sequence[Tuple[int, int]],   # per level (H_l, W_l)
    rois: Tensor,                       # (m, 5) float32
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float,
    max_ratio: int,
    long_span_cap: float | None = None,
) -> BinTaps:
    """Each bin's tap rows and columns merged the way ``csrc/roi_align.cu``
    merges them (the plain statement of its rule, for tests): the bilinear
    weight of a sample factorises into a row and a column weight (validity
    included), so every tap of an axis is summed into the first tap, in
    the order (near, far) of sample 0, 1, ..., that lies on the same row or
    column; the others, and taps whose sum is zero, drop out. The
    1/(gh*gw) average multiplies the row weights."""
    dev = rois.device
    oh, ow = out_size
    offsets, total = [], 0
    for h, w in sizes:
        offsets.append(total)
        total += h * w
    stride_arr = torch.tensor([float(s) for s in strides], device=dev)
    h_arr = torch.tensor([h for h, _ in sizes], device=dev)
    w_arr = torch.tensor([w for _, w in sizes], device=dev)
    lvls = assign_fpn_levels(rois, len(sizes), finest_scale, long_span_cap,
                             float(strides[0]))
    x1, y1, x2, y2 = (rois[:, 1:5] * (1.0 / stride_arr[lvls])[:, None] - 0.5).unbind(1)
    roi_w, roi_h = x2 - x1, y2 - y1
    bin_w, bin_h = _div(roi_w, ow), _div(roi_h, oh)
    gw = torch.ceil(bin_w).clamp(1, max_ratio).int()
    gh = torch.ceil(bin_h).clamp(1, max_ratio).int()
    k = torch.arange(max_ratio, device=dev, dtype=torch.float32)

    def coords(start, binsz, g, o):
        idx = torch.arange(o, device=dev, dtype=torch.float32)
        return (start[:, None, None] + idx[None, :, None] * binsz[:, None, None]
                + (k[None, None, :] + 0.5) * binsz[:, None, None] / g.float()[:, None, None])

    rows, row_w = _merge_axis(coords(y1, bin_h, gh, oh), gh, h_arr[lvls])
    cols, col_w = _merge_axis(coords(x1, bin_w, gw, ow), gw, w_arr[lvls])
    avg = 1.0 / (gh * gw).float()
    base = rois[:, 0].long() * total + torch.tensor(offsets, device=dev)[lvls]
    return BinTaps(base, w_arr[lvls], rows, row_w * avg[:, None, None], cols, col_w)


def axis_interp_matrix(
    coords: Tensor,       # (n, o, k) sample positions along one axis
    kmask: Tensor,        # (n, 1, k) which of the k sub-samples exist
    grid_count: Tensor,   # (n,) adaptive sub-sample count (for averaging)
    origin: Tensor,       # (n,) tile origin (integer, as float)
    size: Tensor,         # (n,) level extent along this axis
    tile: int,
) -> Tensor:
    """Per-RoI interpolation matrix (n, o, tile) folding the bilinear
    weights (the hat function max(0, 1 - |y - r|) over integer taps r),
    the border rules and the bin averaging along one axis
    (``monorun_tpu/ops/roi_align.py:_axis_interp_matrix``)."""
    valid = (coords >= -1.0) & (coords <= size[:, None, None])
    c = torch.minimum(coords.clamp(min=0.0), (size - 1.0)[:, None, None])
    r = origin[:, None, None, None] + torch.arange(
        tile, dtype=coords.dtype, device=coords.device)
    hat = (1.0 - (c[..., None] - r).abs()).clamp(min=0.0)
    w = hat * (valid & (kmask != 0))[..., None]
    return w.sum(2) / grid_count[:, None, None]


def separable_interp(Y: Tensor, tiles: Tensor, X: Tensor,
                     t1_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``out[n, i, j, c] = sum_w X[n, j, w] sum_r Y[n, i, r] tiles[n, r, w, c]``
    in float32; with ``t1_dtype`` the row product (and X) is rounded to
    that dtype before the column product, as the band-matmul kernel's
    stage-1 scratch does. Y (n, o, R), tiles (n, R, W, C), X (n, o, W)."""
    t1 = torch.einsum("nir,nrwc->niwc", Y.float(), tiles.float())
    Xf = X.float()
    if t1_dtype is not None:
        t1 = t1.to(t1_dtype).float()
        Xf = X.to(t1_dtype).float()
    return torch.einsum("njw,niwc->nijc", Xf, t1)


def multilevel_roi_align_tiled(
    features: Sequence[Tensor],   # per level (B, H_l, W_l, C)
    rois: Tensor,                 # (n, 5) image coords
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float = 56.0,
    max_ratio: int = 3,
    tile_hw: Tuple[int, int] = (24, 44),
    chunk_size: int = 256,
    round_weights: bool = False,
) -> Tensor:
    """Plain separable RoIAlign (``roi_align.py:multilevel_roi_align_tiled``
    of the JAX package): each RoI reads one (Th, Tw) tile of its level
    (row segments of the flattened pyramid; overruns land in zero-weight
    columns) and the output is ``Y (oh x Th) @ tile @ X^T (Tw x ow)``
    accumulated in float32. ``round_weights`` rounds Y and X to the
    features' dtype first, as every staged kernel's geometry does
    (``roi_tile_geometry``). Levels by area alone (no span cap), one
    orientation, as in the JAX function. Returns (n, oh, ow, C)."""
    assert len(features) == len(strides)
    B = features[0].shape[0]
    C = features[0].shape[-1]
    oh, ow = out_size
    n = rois.shape[0]
    Th, Tw = tile_hw
    fdtype = features[0].dtype
    dev = rois.device
    sizes = [(f.shape[1], f.shape[2]) for f in features]
    offsets, total = [], 0
    for h, w in sizes:
        offsets.append(total)
        total += h * w
    flat = torch.cat([f.reshape(B, -1, C) for f in features], dim=1).reshape(-1, C)
    # guard row-segment overruns at the very end of the buffer
    flat = torch.cat([flat, flat.new_zeros((Th + 2) * Tw, C)])
    stride_arr = torch.tensor([float(s) for s in strides], device=dev)
    h_arr = torch.tensor([float(h) for h, _ in sizes], device=dev)
    w_arr = torch.tensor([float(w) for _, w in sizes], device=dev)
    off_arr = torch.tensor(offsets, device=dev)
    k = torch.arange(max_ratio, dtype=torch.float32, device=dev)

    out = torch.empty((n, oh, ow, C), dtype=fdtype, device=dev)
    for start in range(0, n, chunk_size):
        rc = rois[start:start + chunk_size].float()
        lvls = assign_fpn_levels(rc, len(sizes), finest_scale)
        Hn, Wn = h_arr[lvls], w_arr[lvls]
        x1, y1, x2, y2 = (rc[:, 1:5] / stride_arr[lvls][:, None] - 0.5).unbind(1)
        bw, bh = _div(x2 - x1, ow), _div(y2 - y1, oh)
        gw = torch.ceil(_div(x2 - x1, ow)).clamp(1, max_ratio)
        gh = torch.ceil(_div(y2 - y1, oh)).clamp(1, max_ratio)
        iy = torch.arange(oh, dtype=torch.float32, device=dev)
        ix = torch.arange(ow, dtype=torch.float32, device=dev)
        ys = (y1[:, None, None] + iy[None, :, None] * bh[:, None, None]
              + (k[None, None, :] + 0.5) * bh[:, None, None] / gh[:, None, None])
        xs = (x1[:, None, None] + ix[None, :, None] * bw[:, None, None]
              + (k[None, None, :] + 0.5) * bw[:, None, None] / gw[:, None, None])
        my = k[None, None, :] < gh[:, None, None]
        mx = k[None, None, :] < gw[:, None, None]
        y0 = torch.minimum(torch.floor(ys.amin((1, 2)).clamp(min=0.0)).clamp(min=0.0),
                           (Hn - Th).clamp(min=0.0))
        x0 = torch.minimum(torch.floor(xs.amin((1, 2)).clamp(min=0.0)).clamp(min=0.0),
                           (Wn - Tw).clamp(min=0.0))
        Y = axis_interp_matrix(ys, my[:, :1], gh, y0, Hn, Th)
        X = axis_interp_matrix(xs, mx[:, :1], gw, x0, Wn, Tw)
        if round_weights:
            Y, X = Y.to(fdtype), X.to(fdtype)
        base = rc[:, 0].long() * total + off_arr[lvls]
        row0 = base + y0.long() * Wn.long() + x0.long()
        idx = (row0[:, None, None]
               + torch.arange(Th, device=dev)[None, :, None] * Wn.long()[:, None, None]
               + torch.arange(Tw, device=dev)[None, None, :])
        out[start:start + rc.shape[0]] = separable_interp(Y, flat[idx], X).to(fdtype)
    return out


# ---- dispatch -------------------------------------------------------------

ALIGN_IMPLS = ("auto", "gather", "sorted", "band", "bandmm")
# proposal scale: from this many RoIs (in bfloat16) "auto" takes the band
# route, as the JAX dispatcher does (roi_align.py:519-522)
BAND_MIN_ROIS = 2048


class AlignChoice(NamedTuple):
    """What ``multilevel_roi_align_auto`` runs: ``gather`` (the plain
    version), ``kernel`` (``csrc/roi_align.cu``, the port of the band and
    sorted TPU kernels), ``tiered`` (``csrc/roi_align_band.cu``) or
    ``bandmm`` (``csrc/roi_align_mma.cu``), with the band options."""

    impl: str
    kroi: int = 0
    t1_dtype: Optional[torch.dtype] = None


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


def align_choice(n_rois: int, dtype: torch.dtype, on_cuda: bool) -> AlignChoice:
    """The implementation an align of ``n_rois`` RoIs in ``dtype`` takes,
    from ``MONORUN_ALIGN_IMPL``, ``MONORUN_BAND_TIERED``,
    ``MONORUN_BAND_MATMUL``, ``MONORUN_BAND_KROI`` and
    ``MONORUN_BAND_T1_BF16``, with the JAX dispatcher's precedence
    (``monorun_tpu/ops/roi_align.py:506-572``): ``bandmm`` forces the
    matmul variant, ``MONORUN_BAND_MATMUL`` applies under ``auto`` only,
    matmul overrides tiered. Off CUDA every setting gives ``gather``, as
    the JAX package does off the TPU."""
    impl = os.environ.get("MONORUN_ALIGN_IMPL", "auto")
    if impl not in ALIGN_IMPLS:
        raise ValueError(f"MONORUN_ALIGN_IMPL={impl!r}; expected one of {ALIGN_IMPLS}")
    if impl == "gather" or not on_cuda:
        return AlignChoice("gather")
    itemsize = torch.empty((), dtype=dtype).element_size()
    if impl in ("band", "bandmm") or (
            impl == "auto" and n_rois >= BAND_MIN_ROIS and itemsize < 4):
        matmul = impl == "bandmm" or (impl != "band" and _env_on("MONORUN_BAND_MATMUL"))
        kroi = int(os.environ.get("MONORUN_BAND_KROI", "16" if matmul else "4"))
        if matmul:
            t1 = torch.bfloat16 if _env_on("MONORUN_BAND_T1_BF16") else None
            return AlignChoice("bandmm", kroi, t1)
        if _env_on("MONORUN_BAND_TIERED"):
            return AlignChoice("tiered", kroi)
    return AlignChoice("kernel")


def prepare_pyramid(features: Sequence[Tensor]):
    """The dual-orientation flat pyramid (``roi_align_tile.FlatPyramid``)
    that the staged kernels read, built once per forward and shared by its
    aligns; None when no align of this process can take a staged kernel
    (CPU tensors, or the environment selects the direct kernel), so the
    default path pays nothing."""
    impl = os.environ.get("MONORUN_ALIGN_IMPL", "auto")
    staged = impl == "bandmm" or (
        impl in ("band", "auto") and (
            _env_on("MONORUN_BAND_TIERED")
            or (impl == "auto" and _env_on("MONORUN_BAND_MATMUL"))))
    if not (features[0].is_cuda and staged):
        return None
    from .roi_align_tile import prepare_flat_pyramid

    return prepare_flat_pyramid(features)


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
    """The align of the detector, dispatched by ``align_choice``; the same
    function on every route (long-span cap ``LONG_SPAN_CAP``). The
    ``gather`` and ``kernel`` routes are differentiable in the levels and
    the RoIs; the staged routes raise under grad. ``tile_h``
    is the staged kernels' tile height, rounded up to 32 rows on the
    16-row grid as on the TPU; ``pyramid`` is ``prepare_pyramid`` of the
    same features."""
    choice = align_choice(rois.shape[0], features[0].dtype, rois.is_cuda)
    if choice.impl == "gather":
        return multilevel_roi_align(
            features, rois, strides, out_size, finest_scale,
            max_ratio=max_ratio, long_span_cap=LONG_SPAN_CAP,
        )
    if choice.impl == "kernel":
        from .roi_align_cuda import roi_align_direct

        return roi_align_direct(features, rois, strides, out_size, finest_scale,
                                max_ratio, LONG_SPAN_CAP)
    from .roi_align_band import multilevel_roi_align_band

    tile_h = ((max(tile_h, 32) + 15) // 16) * 16
    return multilevel_roi_align_band(
        features, rois, strides, out_size, finest_scale, max_ratio=max_ratio,
        tile_hw=(tile_h, 96), kroi=choice.kroi, pyramid=pyramid,
        tiered=choice.impl == "tiered", matmul=choice.impl == "bandmm",
        t1_dtype=choice.t1_dtype,
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
