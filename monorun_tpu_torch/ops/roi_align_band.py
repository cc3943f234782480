"""Staged RoIAlign over 64-row bands: the port's counterpart of
``monorun_tpu/ops/roi_align_band.py:multilevel_roi_align_band``.

RoIs are bucketed by (pyramid buffer, 32-row band of their window's last
row): band k of a buffer holds rows ``[32k - 32, 32k + 32)`` (clipped to
the buffer), so every window of at most 32 rows assigned to it lies
inside. Runs of RoIs are padded to blocks of ``kroi`` slots that lie in
one band; the padding slots are dummies with zero weights. Variants:

* ``tiered``: buckets by (band, column tier), so each block is
  tier-uniform. Kernel ``csrc/roi_align_band.cu`` (port of
  ``roi_align_band.py:142 _band_kernel_tiered``): each block stages the
  union of its RoIs' windows once and serves its RoIs from it.
* ``packed``: orders each band by tier; the TPU kernel computes the row
  product of 4 RoIs at a time as one product of a block-diagonal Y4 with
  the 4 windows stacked along K. Kernel ``csrc/roi_align_mma.cu``
  (``roi_align_band.py:330 _band_kernel_packed``): a block of ``kroi``
  RoIs of one band, each at its own tier.
* ``matmul``: buckets by (band, column panel of ``2 Tw``) and builds Y
  over the whole 64-row band, so a block's row product is one
  (kroi*oh, 64) @ panel product. Kernel ``csrc/roi_align_mma.cu``
  (``roi_align_band.py:227 _band_kernel_matmul``); ``t1_dtype`` rounds
  the row product.
* none of these: the plain band sweep, whose TPU kernel
  (``_band_kernel``) the direct kernel ``csrc/roi_align.cu`` replaces;
  on CUDA it runs that kernel.

The tiered, packed and matmul kernels, and the tile kernel, run one staged
core (``csrc/roi_align_ring.cuh``); ``union_product`` states its
arithmetic in plain PyTorch.

The slotting uses scatter-add histograms, ``searchsorted`` and scatters
(the JAX package avoids them on the TPU) and gives the same slots. The slot count
``m_pad`` is the static worst case, so nothing waits on the device. Each
kernel writes every RoI straight into its output row and orientation;
the plain version (``roi_align_tile.staged_align_plain``) does the same
on the same slots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .roi_align import axis_interp_matrix, refuse_grad
from .roi_align_tile import (
    COL_BLK, MAX_TH, MAX_TW, ROW_BLK, FlatPyramid, TileCall, prepare_flat_pyramid,
    roi_tile_geometry, staged_align_plain,
)

Tensor = torch.Tensor

BAND_STEP = 32          # band granularity (rows)
BAND_ROWS = 64          # rows of a band (covers 32-row windows)
KPACK = 4               # RoIs stacked along K in the packed variant


class BandCall(NamedTuple):
    """The prepared inputs of one band align (kernel or plain version).
    Slot arrays have ``m_pad`` entries, block arrays ``m_pad // kroi``."""

    mode: str                 # "plain", "tiered", "packed" or "matmul"
    bufs: Tuple[Tensor, ...]
    n: int
    kroi: int
    th: int                   # window rows (64 for matmul)
    tw: int
    pw: int                   # panel width (matmul)
    t1_dtype: Optional[torch.dtype]
    row0: Tensor              # slot window row (rw0; dummies: band start)
    col0: Tensor              # slot window column (c0; matmul: in-panel c0rel)
    ncb: Tensor               # slot column tier (dummies 1)
    dst: Tensor               # slot's output row, -1 for dummies
    trans: Tensor             # slot reads the transposed buffer (int32)
    Y: Tensor                 # (m_pad, oh, th)
    X: Tensor                 # (m_pad, ow, tw)
    blk_buf: Tensor
    blk_start: Tensor
    blk_new: Tensor
    blk_slot: Tensor
    blk_ncb: Tensor           # tiered: the block's tier
    blk_po: Tensor            # matmul: panel's first column
    blk_act: Tensor           # matmul: 0 for trailing all-dummy blocks


def prepare_band_call(
    features: Sequence[Tensor],
    rois: Tensor,
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float = 56.0,
    max_ratio: int = 3,
    tile_hw: Tuple[int, int] = (32, 96),
    kroi: int = 8,
    pyramid: Optional[FlatPyramid] = None,
    packed: bool = False,
    tiered: bool = False,
    matmul: bool = False,
    t1_dtype: Optional[torch.dtype] = None,
) -> BandCall:
    """Geometry and slots of ``roi_align_band.py:443-790``, with its option
    precedence: matmul overrides packed and tiered, and packed needs
    ``kroi % 4 == 0`` and not tiered."""
    oh, ow = out_size
    assert oh == ow, "dual-orientation tiles require square outputs"
    n = rois.shape[0]
    Th, Tw = tile_hw
    assert Th <= MAX_TH and Tw <= MAX_TW and Th <= BAND_STEP
    if matmul:
        packed = tiered = False
    packed = packed and not tiered and kroi % KPACK == 0
    mode = "matmul" if matmul else "tiered" if tiered else "packed" if packed else "plain"
    if pyramid is None:
        pyramid = prepare_flat_pyramid(features)
    assert len(pyramid.sizes) == len(strides), "one stride per pyramid level"
    bufs = pyramid.bufs
    dev = rois.device
    rows_list = [int(b.shape[0]) for b in bufs]
    rp_list = [int(b.shape[1]) for b in bufs]
    assert min(rows_list) >= BAND_ROWS, "the band sweep needs >= 64 rows per buffer"
    wmax = max(rp_list)

    geo = roi_tile_geometry(rois.float(), pyramid.sizes, strides, out_size, finest_scale,
                            max_ratio, Th, Tw, features[0].dtype, row_window=True,
                            return_axis_data=matmul)
    rw0, c0, ncb, buf_id = geo.r0.long(), geo.c0.long(), geo.ncb.long(), geo.buf_id.long()
    Y, X = geo.Y, geo.X

    # ---- band assignment: the band of a window's last row ----------------
    kb_counts = [(r + BAND_STEP - 1) // BAND_STEP for r in rows_list]
    base = [0]
    for kb in kb_counts:
        base.append(base[-1] + kb)
    n_bands = base[-1]
    base_arr = torch.tensor(base[:-1], device=dev)
    base_hi = torch.tensor(base[1:], device=dev)
    rows_arr = torch.tensor(rows_list, device=dev)
    band = base_arr[buf_id] + (rw0 + Th - 1) // BAND_STEP

    def band_start_of(band_ids: Tensor) -> Tuple[Tensor, Tensor]:
        bbuf = torch.searchsorted(base_hi, band_ids.contiguous(), right=True)
        kk = band_ids - base_arr[bbuf]
        start = torch.minimum(kk * BAND_STEP - BAND_STEP, rows_arr[bbuf] - BAND_ROWS)
        return bbuf, start.clamp(min=0)

    if matmul:
        # Y over the RoI's whole 64-row band (rows outside its window get
        # exact zero weights), so a block's row product is one product
        a_coords, ma1, ga, A_size, batch, im_rows = geo.axis
        _, bstart_roi = band_start_of(band)
        a0_band = (bstart_roi - batch.long() * im_rows.long()).float()
        Y = axis_interp_matrix(a_coords, ma1, ga, a0_band, A_size, BAND_ROWS).to(Y.dtype)

    # ---- groups, sorted, runs padded to kroi multiples --------------------
    ncq = Tw // COL_BLK
    pw = 0
    if matmul:
        # panel p of a buffer holds columns [po, po + pw) with
        # po = clip(Tw p, 0, rp - min(pw, rp)); buffers no wider than a
        # panel have panel 0 only
        pw = min(2 * Tw, wmax)
        rp_arr = torch.tensor(rp_list, device=dev)
        wcap_arr = rp_arr.clamp(max=pw)
        P = max(1, (wmax - Tw) // Tw + 1)
        pnl = torch.where(rp_arr[buf_id] <= pw, 0, c0 // Tw)
        group = band * P + pnl
        n_groups, worst_runs = n_bands * P, min(n_bands * P, n)
    elif tiered:
        group = band * (ncq + 1) + ncb
        n_groups, worst_runs = n_bands * (ncq + 1), n_bands * ncq
    else:
        group = band
        n_groups, worst_runs = n_bands, n_bands
    sort_key = band * 4 + ncb if packed else group
    order = torch.sort(sort_key, stable=True).indices
    group_sorted = group[order]
    # a scatter-add histogram: bincount would wait on the device for its size
    counts = group.new_zeros(n_groups).scatter_add_(0, group, torch.ones_like(group))
    zero = counts.new_zeros(1)
    cum_counts = torch.cat([zero, counts.cumsum(0)])
    cum_padded = torch.cat([zero, ((counts + kroi - 1) // kroi * kroi).cumsum(0)])
    rank = torch.arange(n, device=dev) - cum_counts[group_sorted]
    slot_sorted = cum_padded[group_sorted] + rank

    m_pad = ((n + (kroi - 1) * worst_runs + kroi - 1) // kroi) * kroi
    # group of each slot; trailing slots past every group take the last
    group_slotted = (torch.searchsorted(cum_padded, torch.arange(m_pad, device=dev),
                                        right=True) - 1).clamp(0, n_groups - 1)
    if matmul:
        band_slotted = group_slotted // P
    elif tiered:
        band_slotted = group_slotted // (ncq + 1)
    else:
        band_slotted = group_slotted
    _, dummy_start = band_start_of(band_slotted)

    def slotted(values: Tensor, fill) -> Tensor:
        out = (fill.clone() if isinstance(fill, Tensor)
               else values.new_full((m_pad,) + values.shape[1:], fill))
        out[slot_sorted] = values[order]
        return out

    row0_p = slotted(rw0, dummy_start)
    c0_p = slotted(c0, 0)
    ncb_p = slotted(ncb, 1)
    dst_p = slotted(torch.arange(n, device=dev), -1)
    trans_p = slotted(geo.tmask.long(), 0)
    Y_p = slotted(Y, 0)
    X_p = slotted(X, 0)

    blk_band = band_slotted[::kroi]
    blk_buf, blk_start = band_start_of(blk_band)
    blk_key = group_slotted[::kroi] if matmul else blk_band
    blk_new = torch.cat([blk_key.new_ones(1), (blk_key[1:] != blk_key[:-1]).long()])
    blk_slot = (blk_new.cumsum(0) - 1) % 2
    nblk = m_pad // kroi
    blk_ncb = (group_slotted[::kroi] % (ncq + 1)).clamp(min=1) if tiered else blk_new.new_zeros(nblk)
    blk_po = blk_act = blk_new.new_zeros(nblk)
    if matmul:
        blk_po = torch.minimum(Tw * (group_slotted[::kroi] % P),
                               rp_arr[blk_buf] - wcap_arr[blk_buf]).clamp(min=0)
        c0_p = (c0_p - blk_po.repeat_interleave(kroi)).clamp(min=0)
        row0_p = blk_start.repeat_interleave(kroi)
        blk_act = (torch.arange(nblk, device=dev) * kroi < cum_padded[-1]).long()

    def i32(t: Tensor) -> Tensor:
        return t.int().contiguous()

    return BandCall(
        mode, bufs, n, kroi, BAND_ROWS if matmul else Th, Tw, pw, t1_dtype,
        i32(row0_p), i32(c0_p), i32(ncb_p), i32(dst_p), i32(trans_p),
        Y_p.contiguous(), X_p.contiguous(), i32(blk_buf), i32(blk_start), i32(blk_new),
        i32(blk_slot), i32(blk_ncb), i32(blk_po), i32(blk_act),
    )


def band_call_plain(call: BandCall) -> Tensor:
    """Plain version of the band kernels on the same prepared slots."""
    kroi = call.kroi
    buf_p = call.blk_buf.repeat_interleave(kroi)
    col0 = call.col0
    if call.mode == "matmul":
        col0 = call.col0 + call.blk_po.repeat_interleave(kroi)
    return staged_align_plain(call.bufs, buf_p, call.row0, col0, call.Y, call.X,
                              call.trans, call.dst, call.n, call.t1_dtype)


class CoreSlots(NamedTuple):
    """The slots of a staged call as the staged core
    (``csrc/roi_align_ring.cuh``) sees them: blocks of ``kroi`` slots, and
    per slot (m_pad,) its buffer and its window, rows ``[row0, row0 +
    rows)`` by columns ``[col0, col0 + width)``."""

    kroi: int
    kmax: int          # most rows a block stages: 64, or a tile's th
    buf: Tensor
    row0: Tensor
    rows: Tensor
    col0: Tensor
    width: Tensor
    dst: Tensor        # output row, -1 for dummies


def core_slots(call) -> CoreSlots:
    """The core's slot windows of a prepared tile call (one slot per block,
    its tier) or band call: matmul, the band by the panel; tiered, ``th``
    rows by the block's tier; packed, ``th`` rows by the slot's own tier."""
    if isinstance(call, TileCall):
        g = call.geo
        return CoreSlots(1, g.Y.shape[2], g.buf_id.long(), g.r0.long(),
                         g.nrb.long() * ROW_BLK, g.c0.long(), g.ncb.long() * COL_BLK,
                         torch.arange(call.n, device=g.Y.device))
    kroi = call.kroi

    def per_slot(blk_values: Tensor) -> Tensor:
        return blk_values.long().repeat_interleave(kroi)

    row0, col0 = call.row0.long(), call.col0.long()
    rows = torch.full_like(row0, call.th)
    if call.mode == "matmul":
        row0, col0 = per_slot(call.blk_start), col0 + per_slot(call.blk_po)
        width = torch.full_like(col0, call.tw)
    elif call.mode == "tiered":
        width = per_slot(call.blk_ncb) * COL_BLK
    elif call.mode == "packed":
        width = call.ncb.long() * COL_BLK
    else:
        raise ValueError("the plain band sweep does not run the staged core")
    return CoreSlots(kroi, BAND_ROWS, per_slot(call.blk_buf), row0, rows, col0, width,
                     call.dst.long())


def union_product(call) -> Tensor:
    """The staged core's arithmetic (``csrc/roi_align_ring.cuh``, which the
    tile, tiered, packed and matmul kernels run) in plain PyTorch, float32.

    Per block, A stacks its real slots' (oh, rows) Y matrices zero-extended
    over the union of their window rows: K rows (the union rounded up to
    16, at most ``kmax``) from ``r0 = min(union start, buffer rows - K)``,
    exact zeros outside each slot's rows. One row product ``A @ window``
    over the union's rows and columns serves every slot; each slot then
    takes only its own columns and X (X is zero past a slot's window, so a
    packed slot narrower than its group gives the TPU kernel's sums at the
    group's widest tier). Same function as ``band_call_plain`` /
    ``tile_call_plain``."""
    s = core_slots(call)
    tile = isinstance(call, TileCall)
    bufs = call.pyramid.bufs if tile else call.bufs
    Y, X = (call.geo.Y, call.geo.X) if tile else (call.Y, call.X)
    trans = call.geo.tmask if tile else call.trans
    t1_dtype = None if tile else call.t1_dtype
    oh, th, C = Y.shape[1], Y.shape[2], bufs[0].shape[-1]
    out = torch.zeros((call.n, oh, oh, C), dtype=bufs[0].dtype, device=Y.device)
    dst = s.dst.view(-1, s.kroi)
    for blk in (dst >= 0).any(1).nonzero().flatten().tolist():
        slots = blk * s.kroi + (dst[blk] >= 0).nonzero().flatten()
        buf = bufs[int(s.buf[slots[0]])]
        rw0, rows, c0, width = s.row0[slots], s.rows[slots], s.col0[slots], s.width[slots]
        rmin, rmax = int(rw0.min()), int((rw0 + rows).max())
        K = min(s.kmax, -(-(rmax - rmin) // 16) * 16)
        r0 = max(0, min(rmin, buf.shape[0] - K))
        cmin, cmax = int(c0.min()), int((c0 + width).max())
        # A[slot, i, k]: Y's column k - (rw0 - r0) inside the slot's rows, else 0
        src = torch.arange(K, device=rw0.device) - (rw0 - r0)[:, None]        # (s, K)
        inside = (src >= 0) & (src < rows[:, None])
        A = Y[slots].float().gather(2, src.clamp(0, th - 1)[:, None, :].expand(-1, oh, -1))
        A = torch.where(inside[:, None, :], A, 0.0)
        t1 = torch.einsum("sik,kwc->siwc", A, buf[r0:r0 + K, cmin:cmax].float())
        Xs = X[slots].float()
        if t1_dtype is not None:
            t1, Xs = t1.to(t1_dtype).float(), X[slots].to(t1_dtype).float()
        W = int(width.max())
        w = torch.arange(W, device=c0.device)
        cols = ((c0 - cmin)[:, None] + w).clamp(max=cmax - cmin - 1)          # (s, W)
        t1 = t1.gather(2, cols[:, None, :, None].expand(-1, oh, -1, C))
        Xs = torch.where((w < width[:, None])[:, None, :], Xs[:, :, :W], 0.0)   # own columns
        res = torch.einsum("sjw,siwc->sijc", Xs, t1)
        res = torch.where(trans[slots].bool()[:, None, None, None], res.transpose(1, 2), res)
        out[s.dst[slots]] = res.to(out.dtype)
    return out


def run_band_call(call: BandCall) -> Tensor:
    """The mode's kernel on CUDA tensors, the plain version on CPU tensors."""
    if not call.Y.is_cuda:
        return band_call_plain(call)
    from . import roi_align_cuda as rc

    kernel = {"tiered": rc.band_tiered_kernel, "packed": rc.band_packed_kernel,
              "matmul": rc.band_matmul_kernel}.get(call.mode)
    if kernel is None:
        raise ValueError("the plain band sweep runs the direct kernel; "
                         "use multilevel_roi_align_band")
    return kernel(call)


def multilevel_roi_align_band(
    features: Sequence[Tensor],   # per level (B, H_l, W_l, C)
    rois: Tensor,                 # (n, 5)
    strides: Sequence[int],
    out_size: Tuple[int, int],
    finest_scale: float = 56.0,
    max_ratio: int = 3,
    tile_hw: Tuple[int, int] = (32, 96),
    kroi: int = 8,
    pyramid: Optional[FlatPyramid] = None,
    packed: bool = False,
    tiered: bool = False,
    matmul: bool = False,
    t1_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """Band-sweep RoIAlign; same function as ``roi_align.multilevel_roi_align``
    with the span cap ``Tw - 18``, up to the rounding of the interpolation
    weights (and of the row product under ``t1_dtype``)."""
    refuse_grad("band", features, rois)
    plain_band = not (matmul or tiered or (packed and kroi % KPACK == 0))
    if rois.is_cuda and plain_band:
        from .roi_align_cuda import roi_align_kernel

        return roi_align_kernel(
            [f.contiguous() for f in features], rois.float().contiguous(), strides,
            out_size, finest_scale, max_ratio, tile_hw[1] - 18,
        )
    return run_band_call(prepare_band_call(
        features, rois, strides, out_size, finest_scale, max_ratio, tile_hw, kroi,
        pyramid, packed, tiered, matmul, t1_dtype))
