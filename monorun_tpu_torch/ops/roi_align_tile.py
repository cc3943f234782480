"""Staged RoIAlign, per-RoI tiles: the port's counterpart of
``monorun_tpu/ops/roi_align_pallas.py``.

* ``prepare_flat_pyramid`` lays every level out twice, row-major and
  transposed, as 3-D ``(B * rows, row_len, C)`` buffers, so a RoI's tile
  is one strided window at any row origin. Each RoI reads the orientation
  whose short axis is the tile's row axis: a single orientation silently
  clips tall RoIs (pedestrians).
* ``roi_tile_geometry`` gives each RoI its buffer, its window origin (the
  in-row origin snapped down to 16 columns), the (16-row x 32-column)
  tier its taps touch, and the interpolation matrices Y (oh, Th) and
  X (ow, Tw) that fold bilinear weights, border rules and bin averaging.
  Both are rounded to the features' dtype, as on the TPU.
* ``multilevel_roi_align_tile`` computes ``Y @ tile @ X^T`` per RoI: on
  CUDA tensors in the hand-written kernel ``csrc/roi_align_tile.cu``
  (port of ``roi_align_pallas.py:55 _kernel``), on CPU tensors in the
  plain version ``staged_align_plain``, which the band variants
  (``roi_align_band.py``) share.

The tensor preparation runs as PyTorch ops on the features' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .roi_align import (
    _div, assign_fpn_levels, axis_interp_matrix, refuse_grad, separable_interp,
)

Tensor = torch.Tensor

# largest tile (rows, columns); also the least padded in-row extent
MAX_TH, MAX_TW = 32, 96
# least rows of a buffer: the band kernels read fixed 64-row windows
GUARD_ROWS = 64
# tier granularity of the tile copy
ROW_BLK, COL_BLK = 16, 32


class FlatPyramid(NamedTuple):
    """``bufs[2 l]`` is level l row-major, ``bufs[2 l + 1]`` transposed."""

    bufs: Tuple[Tensor, ...]
    sizes: Tuple[Tuple[int, int], ...]
    batch: int


class TileGeometry(NamedTuple):
    tmask: Tensor    # (m,) bool: tall RoI, reads the transposed buffer
    Y: Tensor        # (m, oh, Th) tile-row interpolation, features' dtype
    X: Tensor        # (m, ow, Tw) in-row interpolation, features' dtype
    r0: Tensor       # (m,) int32 first window row in the buffer
    c0: Tensor       # (m,) int32 in-row origin, a multiple of 16
    nrb: Tensor      # (m,) int32 row blocks of 16 the taps touch
    ncb: Tensor      # (m,) int32 column blocks of 32 the taps touch
    buf_id: Tensor   # (m,) int32 2 * level + transposed
    # (m,) bool: every tap with a non-zero weight lies in the (Th, Tw)
    # window. The span cap assumes each level doubles the stride; with the
    # lazy lower level (strides 4, 4, 8, ...) a sliver at level 1 can span
    # up to twice Tw, and its taps beyond the window are dropped, as in the
    # JAX package's kernels
    fits: Tensor
    # tile-row axis data to rebuild Y at another origin (band matmul):
    # (coords, kmask, grid count, extent, batch, rows per image)
    axis: Optional[tuple] = None


def prepare_flat_pyramid(features: Sequence[Tensor]) -> FlatPyramid:
    """Dual-orientation level buffers shared across align calls
    (``roi_align_pallas.py:prepare_flat_pyramid``).

    A buffer whose rows cover a full tile (``rows >= MAX_TH``, at least
    ``GUARD_ROWS`` in all) and whose row length is at least ``MAX_TW`` and
    a multiple of 16 is the level itself, reshaped: windows are clamped
    inside each image and the 16-snapped in-row origin never passes the
    row end. Any other buffer is padded in-row to a multiple of 16 plus
    16 columns of slack (the snap may move the window up to 15 columns
    right of the extent) and gets zero guard rows below, at least
    ``MAX_TH`` and enough for ``GUARD_ROWS`` rows in all."""
    B = features[0].shape[0]
    C = features[0].shape[-1]

    def flat(f3: Tensor) -> Tensor:
        _, rows, rlen, _ = f3.shape
        if (rows >= MAX_TH and B * rows >= GUARD_ROWS
                and rlen >= MAX_TW and rlen % 16 == 0):
            return f3.reshape(B * rows, rlen, C).contiguous()
        rp = -(-max(rlen, MAX_TW) // 16) * 16 + 16
        g = F.pad(f3, (0, 0, 0, rp - rlen)).reshape(B * rows, rp, C)
        guard = max(MAX_TH, GUARD_ROWS - B * rows)
        return torch.cat([g, g.new_zeros(guard, rp, C)])

    bufs = []
    for f in features:
        bufs.append(flat(f))
        bufs.append(flat(f.transpose(1, 2)))
    return FlatPyramid(tuple(bufs), tuple((f.shape[1], f.shape[2]) for f in features), B)


def roi_tile_geometry(
    rois: Tensor,                          # (m, 5) float32 image coords
    sizes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float,
    max_ratio: int,
    Th: int,
    Tw: int,
    fdtype: torch.dtype,
    row_window: bool = False,
    return_axis_data: bool = False,
) -> TileGeometry:
    """Per-RoI tile geometry (``roi_align_pallas.py:roi_tile_geometry``).

    Levels carry the long-side cap ``Tw - 18``, so every tap with a
    non-zero weight fits the (Th, Tw) window after the 16-snap. With
    ``row_window`` (band kernels) ``r0`` is instead the origin of a fixed
    Th-row window ending at the tier's last row block, clipped at buffer
    row 0, and Y is built at that origin."""
    oh, ow = out_size
    dev = rois.device
    stride_arr = torch.tensor([float(s) for s in strides], device=dev)
    h_arr = torch.tensor([float(h) for h, _ in sizes], device=dev)
    w_arr = torch.tensor([float(w) for _, w in sizes], device=dev)

    assert 2.0 * finest_scale / strides[0] <= Th - 2, (finest_scale, Th)
    lvls = assign_fpn_levels(rois, len(sizes), finest_scale, long_span_cap=Tw - 18,
                             stride0=float(strides[0]))
    Hn, Wn = h_arr[lvls], w_arr[lvls]
    x1, y1, x2, y2 = (rois[:, 1:5] / stride_arr[lvls][:, None] - 0.5).unbind(1)
    bw, bh = _div(x2 - x1, ow), _div(y2 - y1, oh)
    gw = torch.ceil(_div(x2 - x1, ow)).clamp(1, max_ratio)
    gh = torch.ceil(_div(y2 - y1, oh)).clamp(1, max_ratio)

    k = torch.arange(max_ratio, dtype=torch.float32, device=dev)
    iy = torch.arange(oh, dtype=torch.float32, device=dev)
    ix = torch.arange(ow, dtype=torch.float32, device=dev)
    ys = (y1[:, None, None] + iy[None, :, None] * bh[:, None, None]
          + (k[None, None, :] + 0.5) * bh[:, None, None] / gh[:, None, None])
    xs = (x1[:, None, None] + ix[None, :, None] * bw[:, None, None]
          + (k[None, None, :] + 0.5) * bw[:, None, None] / gw[:, None, None])
    my = k[None, None, :] < gh[:, None, None]
    mx = k[None, None, :] < gw[:, None, None]

    # orientation: the shorter RoI axis becomes the tile's row axis
    tmask = (y2 - y1) > (x2 - x1)
    tm = tmask[:, None, None]
    a_coords = torch.where(tm, xs, ys)
    b_coords = torch.where(tm, ys, xs)
    ga, gb = torch.where(tmask, gw, gh), torch.where(tmask, gh, gw)
    ma, mb = torch.where(tm, mx, my), torch.where(tm, my, mx)
    A_size, B_size = torch.where(tmask, Wn, Hn), torch.where(tmask, Hn, Wn)

    a0 = torch.minimum(torch.floor(a_coords.amin((1, 2)).clamp(min=0.0)).clamp(min=0.0),
                       (A_size - Th).clamp(min=0.0))
    b0 = torch.minimum(torch.floor(b_coords.amin((1, 2)).clamp(min=0.0)).clamp(min=0.0),
                       (B_size - Tw + 15.0).clamp(min=0.0))
    b0 = torch.floor(b0 / 16.0) * 16.0

    # last row / column that a tap with a non-zero weight touches
    neg = torch.tensor(-1e9, device=dev)
    a_hi = torch.where(ma, a_coords, neg).amax((1, 2))
    b_hi = torch.where(mb, b_coords, neg).amax((1, 2))
    a_hi = torch.minimum(torch.floor(a_hi) + 1.0, A_size - 1.0)
    b_hi = torch.minimum(torch.floor(b_hi) + 1.0, B_size - 1.0)
    fits = (a_hi - a0 < Th) & (b_hi - b0 < Tw)
    nrb = torch.floor((a_hi - a0) / ROW_BLK).clamp(0, Th // ROW_BLK - 1).int() + 1
    ncb = torch.floor((b_hi - b0) / COL_BLK).clamp(0, Tw // COL_BLK - 1).int() + 1

    rows = torch.where(tmask, Wn, Hn).int()     # image rows of the chosen buffer
    batch = rois[:, 0].int()
    r0 = batch * rows + a0.int()
    if row_window:
        r0 = (r0 + nrb * ROW_BLK - Th).clamp(min=0)
        a0 = (r0 - batch * rows).float()
    Y = axis_interp_matrix(a_coords, ma[:, :1], ga, a0, A_size, Th).to(fdtype)
    X = axis_interp_matrix(b_coords, mb[:, :1], gb, b0, B_size, Tw).to(fdtype)
    axis = (a_coords, ma[:, :1], ga, A_size, batch, rows) if return_axis_data else None
    return TileGeometry(tmask, Y, X, r0.int(), b0.int(), nrb, ncb,
                        (lvls.int() * 2 + tmask.int()), fits, axis)


def staged_align_plain(
    bufs: Sequence[Tensor],
    buf_id: Tensor,       # (m,) buffer of each slot
    row0: Tensor,         # (m,) first window row
    col0: Tensor,         # (m,) first window column
    Y: Tensor,            # (m, oh, R)
    X: Tensor,            # (m, ow, W)
    trans: Tensor,        # (m,) bool: transposed buffer
    dst: Tensor,          # (m,) output row of each slot, -1 for none
    n: int,
    t1_dtype: Optional[torch.dtype] = None,
    chunk: int = 128,
) -> Tensor:
    """Plain version of every staged kernel, on their prepared inputs:
    each slot with ``dst >= 0`` reads its (R, W) window of
    ``bufs[buf_id]`` at (row0, col0), computes ``Y @ window @ X^T`` in
    float32 (``separable_interp``), transposes it back for tall RoIs and
    lands in output row ``dst``. Returns (n, oh, ow, C)."""
    oh, R = Y.shape[1], Y.shape[2]
    W = X.shape[2]
    C = bufs[0].shape[-1]
    dev = Y.device
    out = torch.zeros((n, oh, oh, C), dtype=bufs[0].dtype, device=dev)
    slots = (dst >= 0).nonzero().squeeze(1)
    ar_r = torch.arange(R, device=dev)
    ar_c = torch.arange(W, device=dev)
    for start in range(0, slots.numel(), chunk):
        s = slots[start:start + chunk]
        tiles = bufs[0].new_empty((s.numel(), R, W, C))
        bid = buf_id[s]
        for b, buf in enumerate(bufs):
            sel = (bid == b).nonzero().squeeze(1)
            if sel.numel():
                rr = (row0[s[sel]].long()[:, None] + ar_r)[:, :, None]
                cc = (col0[s[sel]].long()[:, None] + ar_c)[:, None, :]
                tiles[sel] = buf[rr, cc]
        res = separable_interp(Y[s], tiles, X[s], t1_dtype)     # (k, i, j, C)
        res = torch.where(trans[s].bool()[:, None, None, None], res.transpose(1, 2), res)
        out[dst[s].long()] = res.to(out.dtype)
    return out


class TileCall(NamedTuple):
    """The prepared inputs of one tile align (kernel or plain version)."""

    pyramid: FlatPyramid
    geo: TileGeometry
    n: int


def prepare_tile_call(
    features: Sequence[Tensor], rois: Tensor, strides: Sequence[int],
    out_size: Tuple[int, int], finest_scale: float, max_ratio: int,
    tile_hw: Tuple[int, int] = (MAX_TH, MAX_TW), pyramid: Optional[FlatPyramid] = None,
) -> TileCall:
    oh, ow = out_size
    assert oh == ow, "dual-orientation tiles require square outputs"
    Th, Tw = tile_hw
    assert Th <= MAX_TH and Tw <= MAX_TW, (Th, Tw)
    assert Th % ROW_BLK == 0 and Tw % COL_BLK == 0, (Th, Tw)
    if pyramid is None:
        pyramid = prepare_flat_pyramid(features)
    assert len(pyramid.sizes) == len(strides), "one stride per pyramid level"
    geo = roi_tile_geometry(rois.float(), pyramid.sizes, strides, out_size, finest_scale,
                            max_ratio, Th, Tw, features[0].dtype)
    return TileCall(pyramid, geo, rois.shape[0])


def tile_call_plain(call: TileCall) -> Tensor:
    """Plain version of the tile kernel on the same prepared inputs."""
    g = call.geo
    return staged_align_plain(call.pyramid.bufs, g.buf_id, g.r0, g.c0, g.Y, g.X, g.tmask,
                              torch.arange(call.n, device=g.Y.device), call.n)


def run_tile_call(call: TileCall) -> Tensor:
    """The tile kernel on CUDA tensors, its plain version on CPU tensors."""
    if call.geo.Y.is_cuda:
        from .roi_align_cuda import tile_kernel

        return tile_kernel(call)
    return tile_call_plain(call)


def multilevel_roi_align_tile(
    features: Sequence[Tensor],   # per level (B, H_l, W_l, C)
    rois: Tensor,                 # (n, 5)
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float = 56.0,
    max_ratio: int = 3,
    tile_hw: Tuple[int, int] = (MAX_TH, MAX_TW),
    pyramid: Optional[FlatPyramid] = None,
) -> Tensor:
    """Tile RoIAlign, the counterpart of
    ``monorun_tpu/ops/roi_align_pallas.py:multilevel_roi_align_pallas``;
    same function as ``roi_align.multilevel_roi_align`` with the span cap
    ``Tw - 18``, up to the rounding of Y and X to the features' dtype.
    ``pyramid`` is ``prepare_flat_pyramid`` of the same features.
    Forward-only: inputs that require grad raise under grad."""
    refuse_grad("tile", features, rois)
    return run_tile_call(prepare_tile_call(features, rois, strides, out_size, finest_scale,
                                           max_ratio, tile_hw, pyramid))
