"""The direct CUDA kernel's per-bin tap merging, stated in plain PyTorch
(``monorun_tpu_torch/ops/roi_align.py:merged_bin_taps``), against the JAX
package's gather align.

Each bin is rebuilt from its merged row and column lists alone and held to
``monorun_tpu/ops/roi_align.py:multilevel_roi_align`` on the same numpy
inputs in float32 at 1e-6 relative plus 1e-6 absolute. The rebuild sums
in float64, so what is left is the JAX side's float32 rounding and the
merged weights' own; the kernel's float32 channel sums are held to the
plain version on the card (``test_torch_cuda.py``).

Cases: 7x7 with ``max_ratio`` 6 and 14x14 with ``max_ratio`` 4, on a lazy
pyramid (level 0 stored at stride 4): random boxes, samples outside
[-1, size] on every side, RoIs on the last row and column (the far tap
clamped onto the near one), lazy-level slivers whose samples lie more than
one cell apart, zero-size padded RoIs.

The merged taps against the JAX align are in
``test_torch_roi_align_merge_jax.py``: files of at most 3 tests, which xdist
hands out late (ROADMAP's test-time budget).
"""

import numpy as np
import pytest
import torch

from monorun_tpu_torch.ops import roi_align as tra

from torch_share import cpu_share  # noqa: F401

STRIDES = (4, 4, 8, 16)
H, W, C, B = 64, 640, 8, 2
CAP = 96 - 18
SPECIAL = np.array(
    [
        [0, 0.0, 0.0, 0.0, 0.0],          # zero-size padded slot
        [1, 0.0, 0.0, 0.0, 0.0],          # another, on the second image
        [0, 10.0, 30.0, 610.0, 31.0],     # 600x1 sliver: level 1 at stride 4, 150 cells
        [1, 20.0, 50.0, 630.0, 52.0],     # 610x2 sliver near the bottom
        [0, -40.0, -30.0, 60.0, 20.0],    # samples below -1 in x and y
        [1, 560.0, 40.0, 720.0, 90.0],    # samples beyond the right and bottom edges
        [0, 600.0, 48.0, 640.0, 64.0],    # on the last row and column
        [1, 636.0, 61.0, 640.0, 64.0],    # tiny, in the last cell: far taps clamp
        [0, 5.0, 5.0, 6.5, 6.0],          # tiny box
        [1, 100.0, 0.0, 400.0, 64.0],     # wide box, full height
    ],
    np.float32,
)
CASES = [((7, 7), 10.0, 6), ((14, 14), 14.0, 4)]


def _pyramid(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H // s, W // s, C)).astype(np.float32) for s in STRIDES]


def _rois(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, W - 4, n)
    y1 = rng.uniform(0, H - 4, n)
    x2 = np.clip(x1 + rng.uniform(1, 300.0, n), None, W)
    y2 = np.clip(y1 + rng.uniform(1, 60.0, n), None, H)
    rand = np.stack([rng.integers(0, B, n), x1, y1, x2, y2], 1).astype(np.float32)
    return np.concatenate([rand, SPECIAL])


def _taps(rois, out_size, finest, max_ratio):
    sizes = [(H // s, W // s) for s in STRIDES]
    return tra.merged_bin_taps(sizes, torch.from_numpy(rois), STRIDES, out_size, finest,
                               max_ratio, CAP)


def _rebuild(feats, taps):
    """Every bin from its merged lists: sum over rows a and columns b of
    (row_w * col_w) * F[row a, column b], in float64."""
    flat = torch.cat([torch.from_numpy(f).reshape(B, -1, C) for f in feats], 1).reshape(-1, C)
    idx = (taps.base[:, None, None, None, None]
           + taps.rows[:, :, None, :, None] * taps.width[:, None, None, None, None]
           + taps.cols[:, None, :, None, :])
    w = taps.row_w[:, :, None, :, None] * taps.col_w[:, None, :, None, :]
    idx = torch.where(w != 0, idx, 0)
    return (w.double()[..., None] * flat[idx].double()).sum((3, 4))


@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_merged_lists_hold_each_tap_once(out_size, finest, max_ratio):
    """At most 2 * max_ratio entries per axis, no row or column twice, no
    weight on a zero-size slot beyond its one cell, fewer taps than the
    4 per sample of the unmerged version, and no merging where samples
    lie more than one cell apart (the slivers)."""
    rois = _rois()
    t = _taps(rois, out_size, finest, max_ratio)
    oh, ow = out_size
    for taps, w in ((t.rows, t.row_w), (t.cols, t.col_w)):
        assert taps.shape[-1] == 2 * max_ratio
        on = w != 0
        same = (taps[..., :, None] == taps[..., None, :]) & on[..., :, None] & on[..., None, :]
        assert int(same.sum()) == int(on.sum())      # each entry matches only itself
    n_rows = (t.row_w != 0).sum(-1)                  # (m, oh)
    n_cols = (t.col_w != 0).sum(-1)                  # (m, ow)
    distinct = (n_rows[:, :, None] * n_cols[:, None, :]).sum((1, 2))
    sizes = [(H // s, W // s) for s in STRIDES]
    _, weights, avg = tra.sample_taps(sizes, torch.from_numpy(rois), STRIDES, out_size,
                                      finest, max_ratio, CAP)
    unmerged = ((weights > 0) & (avg > 0)).sum((0, 2))
    assert bool((distinct <= unmerged).all()) and int(distinct.sum()) < int(unmerged.sum())
    # the zero-size slots: one sample per bin at (-0.5, -0.5), in the
    # first cell, one tap per axis
    for r in (24, 25):
        assert (n_rows[r] == 1).all() and (n_cols[r] == 1).all()
    # the 600x1 sliver: max_ratio columns per bin, spaced by more than one
    # cell, so no column merges (2 taps per sample)
    spacing = (600 / 4) / ow / max_ratio
    assert spacing > 1
    assert (n_cols[26, 1:-1] == 2 * max_ratio).all()
    # a box whose samples are all valid: its rows sum to gh / (gh * gw)
    # (the average folded in), its columns to gw, so every bin's weights
    # to 1
    box = 33
    total = t.row_w[box].sum(-1)[:, None] * t.col_w[box].sum(-1)[None, :]
    torch.testing.assert_close(total, torch.ones(oh, ow), rtol=1e-6, atol=1e-6)
