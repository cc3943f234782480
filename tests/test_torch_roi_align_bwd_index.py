"""The RoIAlign backward's index pass in plain PyTorch
(``monorun_tpu_torch/ops/roi_align.py:backward_index``, the rule of the
per-RoI kernel and the bucket sort of ``csrc/roi_align_bwd.cu``) against
the plain version's own taps (``sample_taps``), on the CPU.

At the training step's three align shapes (``kitti_multiclass``: sampled
and positive RoIs at 7x7, finest scale 20, at most 6 samples a bin; the
positives at 14x14, finest scale 28, at most 4), on the step's pyramid
(a 384x1280 canvas at the lazy strides 4, 4, 8, 16, 32, batch 3): random
RoIs, lazy-level slivers, RoIs that the long-side cap pushes coarser, RoIs
on the canvas edge and past it, zero-area RoIs and zero slots, and no RoIs.
Every tap of ``sample_taps`` with a nonzero weight lies on its RoI's key's
image and level, the rectangle is exactly the box of those taps, and each
bucket holds its key's RoIs in RoI order. The tile kernel reads these
rectangles to skip RoIs; the card tests hold the kernel's own index pass
to this one (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from monorun_tpu_torch.ops import roi_align as ra

from torch_share import cpu_share  # noqa: F401

STRIDES = (4, 4, 8, 16, 32)
CANVAS = (384, 1280)
BATCH = 3
SIZES = [(CANVAS[0] // s, CANVAS[1] // s) for s in STRIDES]
SHAPES = {"sampled 7x7": ((7, 7), 20.0, 6), "positives 7x7": ((7, 7), 20.0, 6),
          "positives 14x14": ((14, 14), 28.0, 4)}
EDGE_CASES = np.array([
    [0, 10.0, 50.0, 480.0, 60.0],        # lazy-level slivers
    [1, 20.0, 30.0, 420.0, 42.0],
    [2, 0.0, 100.0, 700.0, 112.0],       # long sides the cap pushes coarser
    [0, 300.0, 2.0, 340.0, 380.0],
    [1, 1200.0, 300.0, 1280.0, 384.0],   # on the canvas edge
    [2, 1250.0, 350.0, 1330.0, 420.0],   # past it
    [0, -40.0, -30.0, 20.0, 10.0],
    [1, 1300.0, 100.0, 1400.0, 200.0],   # wholly past it
    [2, 500.0, 200.0, 500.0, 200.0],     # zero area
    [0, 640.0, 100.0, 640.0, 180.0],     # zero width
    [0, 0.0, 0.0, 0.0, 0.0],             # zero slot
    [2, 1279.0, 383.0, 1280.0, 384.0],   # the canvas's last cell
], np.float32)


def _rois(label, n=400, seed=0):
    """Random KITTI-like RoIs (log-uniform sides, as the step samples), then
    the edge cases."""
    rng = np.random.default_rng(seed + len(label))
    lo, hi = (2.0, 600.0) if label.startswith("sampled") else (10.0, 400.0)
    side = lo * (hi / lo) ** rng.uniform(size=n)
    aspect = 4.0 ** rng.uniform(-1, 1, size=n)
    w, h = side * np.sqrt(aspect), side / np.sqrt(aspect)
    x1, y1 = rng.uniform(0, CANVAS[1], n), rng.uniform(0, CANVAS[0], n)
    rois = np.stack([rng.integers(0, BATCH, n), x1, y1, np.minimum(x1 + w, CANVAS[1]),
                     np.minimum(y1 + h, CANVAS[0])], 1).astype(np.float32)
    return torch.from_numpy(np.concatenate([rois, EDGE_CASES]))


@pytest.mark.parametrize("label", list(SHAPES))
def test_index_holds_every_tap(label):
    out_size, finest, max_ratio = SHAPES[label]
    rois = _rois(label)
    ix = ra.backward_index(SIZES, rois, STRIDES, out_size, finest, max_ratio,
                           ra.LONG_SPAN_CAP, BATCH)
    rows, weights, avg = ra.sample_taps(SIZES, rois, STRIDES, out_size, finest, max_ratio,
                                        ra.LONG_SPAN_CAP)
    L, total = len(SIZES), sum(h * w for h, w in SIZES)
    offsets = np.cumsum([0] + [h * w for h, w in SIZES])
    keys = ix.keys.numpy()
    b, lvl = keys // L, keys % L
    assert (b == np.clip(rois[:, 0].numpy().astype(np.int64), 0, BATCH - 1)).all()
    live = ((weights != 0) & (avg > 0)[None]).numpy()        # (4, m, P)
    cell = rows.numpy() - (b * total + offsets[lvl])[None, :, None]
    width = np.array([w for _, w in SIZES])[lvl][None, :, None]
    area = np.array([h * w for h, w in SIZES])[lvl][None, :, None]
    # every live tap on its RoI's image and level
    assert ((cell >= 0) & (cell < area))[live].all()
    y, x = cell // width, cell % width
    rects = ix.rects.numpy()
    big = np.iinfo(np.int64).max
    for i in range(rois.shape[0]):
        m = live[:, i]
        want = ((y[:, i][m].min(), y[:, i][m].max() + 1, x[:, i][m].min(),
                 x[:, i][m].max() + 1) if m.any() else (0, 0, 0, 0))
        assert tuple(rects[i]) == tuple(want), (i, rois[i].tolist())
        assert big not in rects[i]
    # a RoI wholly past the canvas reaches no cell, every other one some
    assert tuple(rects[-5]) == (0, 0, 0, 0)
    assert (rects[:-5, 1] > rects[:-5, 0]).all()


@pytest.mark.parametrize("label", list(SHAPES))
def test_buckets_keep_roi_order(label):
    out_size, finest, max_ratio = SHAPES[label]
    rois = _rois(label, n=200, seed=1)
    ix = ra.backward_index(SIZES, rois, STRIDES, out_size, finest, max_ratio,
                           ra.LONG_SPAN_CAP, BATCH)
    keys, order, offsets = ix.keys.numpy(), ix.order.numpy(), ix.offsets.numpy()
    assert offsets[0] == 0 and offsets[-1] == rois.shape[0]
    assert len(offsets) == BATCH * len(SIZES) + 1 and (np.diff(offsets) >= 0).all()
    for k in range(BATCH * len(SIZES)):
        got = order[offsets[k]:offsets[k + 1]]
        assert got.tolist() == np.flatnonzero(keys == k).tolist(), k
    # the cap pushes the long slivers off the finest level
    assert (keys[-12:-10] % len(SIZES) >= 1).all()


def test_index_of_no_rois():
    ix = ra.backward_index(SIZES, torch.zeros((0, 5)), STRIDES, (7, 7), 20.0, 6,
                           ra.LONG_SPAN_CAP, BATCH)
    assert ix.keys.shape == (0,) and ix.rects.shape == (0, 4) and ix.order.shape == (0,)
    assert ix.offsets.tolist() == [0] * (BATCH * len(SIZES) + 1)
