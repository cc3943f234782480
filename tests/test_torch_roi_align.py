"""The port's RoIAlign op layer against the JAX package's.

The plain PyTorch version (monorun_tpu_torch/ops/roi_align.py) is held to
the JAX gather oracle ``multilevel_roi_align(..., long_span_cap=78)`` in
float32 at 2e-5 (summation order only), on random boxes plus the
degenerate cases of the Pallas kernels' own tests: slivers that the
long-span cap moves, a zero-size padded slot, a tiny box, a box
straddling a band edge. One case each goes against the sorted and the
band Pallas kernels run in interpret mode. The CUDA kernel is held to the
plain version on the card in ``test_torch_cuda.py``.

The Pallas kernels' cases are in ``test_torch_roi_align_pallas.py``: files of
at most 3 tests, which xdist hands out late (ROADMAP's test-time budget).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models.detector import _align_strides
from monorun_tpu.ops import roi_align as jra
from monorun_tpu_torch.ops import roi_align as tra

from torch_share import cpu_share  # noqa: F401

STRIDES = (2, 4, 8, 16)
CAP = 96 - 18
TOL = dict(rtol=2e-5, atol=2e-5)

SPECIAL = np.array(
    [
        [0, 0.0, 0.0, 0.0, 0.0],        # zero-size padded slot
        [0, 2.0, 60.0, 120.0, 64.0],    # 118x4 bottom sliver
        [1, 100.0, 0.0, 128.0, 3.0],    # top-right sliver
        [1, 10.0, 10.0, 90.0, 30.0],    # wide aspect-4 box
        [0, 5.0, 5.0, 6.5, 6.0],        # tiny box
        [0, 0.0, 28.0, 30.0, 36.0],     # straddles a 32-row band edge
        [1, -3.0, -2.0, 40.0, 70.0],    # reaches past the map (samples < -1)
    ],
    np.float32,
)


def _pyramid(B=2, H=64, W=128, C=32, strides=STRIDES, seed=0):
    return [
        np.random.default_rng(seed + l)
        .normal(size=(B, H // s, W // s, C)).astype(np.float32)
        for l, s in enumerate(strides)
    ]


def _rois(n=24, B=2, H=64, W=128, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, W - 4, n)
    y1 = rng.uniform(0, H - 4, n)
    x2 = np.clip(x1 + rng.uniform(1, 60.0, n), None, W)
    y2 = np.clip(y1 + rng.uniform(1, 40.0, n), None, H)
    b = rng.integers(0, B, n)
    rand = np.stack([b, x1, y1, x2, y2], 1).astype(np.float32)
    return np.concatenate([rand, SPECIAL])


def _jax_align(feats, rois, strides, out_size, finest, max_ratio):
    return np.asarray(jax.jit(lambda f, r: jra.multilevel_roi_align(
        f, r, strides, out_size,
        finest, sampling_ratio=0, max_ratio=max_ratio, long_span_cap=CAP,
    ))([jnp.asarray(f) for f in feats], jnp.asarray(rois)))


def _port_align(feats, rois, strides, out_size, finest, max_ratio):
    return tra.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois), strides,
        out_size, finest, max_ratio=max_ratio, long_span_cap=CAP,
    ).numpy()


@pytest.mark.parametrize(
    "out_size,finest,max_ratio",
    [((7, 7), 10.0, 3), ((7, 7), 10.0, 6), ((14, 14), 14.0, 2),
     ((14, 14), 14.0, 4)],
)
def test_plain_matches_jax_gather_oracle(out_size, finest, max_ratio):
    feats, rois = _pyramid(), _rois()
    got = _port_align(feats, rois, STRIDES, out_size, finest, max_ratio)
    ref = _jax_align(feats, rois, STRIDES, out_size, finest, max_ratio)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_chunking_matches_one_block():
    feats, rois = _pyramid(), _rois()
    args = (STRIDES, (7, 7), 10.0)
    t = [torch.from_numpy(f) for f in feats]
    one = tra.multilevel_roi_align(t, torch.from_numpy(rois), *args,
                                   max_ratio=3, long_span_cap=CAP)
    chunked = tra.multilevel_roi_align(t, torch.from_numpy(rois), *args,
                                       max_ratio=3, chunk_size=5,
                                       long_span_cap=CAP)
    torch.testing.assert_close(chunked, one, rtol=0, atol=0)


def _interpret(module):
    orig = module.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return mock.patch.object(module.pl, "pallas_call", patched)


def test_lazy_lower_stride_rule():
    """Level 0 declared at stride 2 but stored at stride 4 (lazy_lower):
    the aligns sample it with strides (4, 4, 8, 16, 32)."""
    cfg = get_config("kitti_multiclass")
    declared = cfg.bbox_head.featmap_strides
    for lazy in (True, False):
        c = dataclasses.replace(cfg, neck=dataclasses.replace(cfg.neck, lazy_lower=lazy))
        assert tra.align_strides(lazy, declared) == _align_strides(c, declared)
    strides = tra.align_strides(True, STRIDES)
    assert strides == (4, 4, 8, 16)
    feats = _pyramid(strides=strides, seed=3)
    rois = _rois(seed=3)
    got = _port_align(feats, rois, strides, (7, 7), 10.0, 6)
    ref = _jax_align(feats, rois, strides, (7, 7), 10.0, 6)
    np.testing.assert_allclose(got, ref, **TOL)


def test_level_assignment_with_long_span_cap():
    rois = _rois(n=64, seed=5)
    for cap in (None, CAP):
        got = tra.assign_fpn_levels(torch.from_numpy(rois), 4, 10.0, cap, 2.0)
        ref = jra.assign_fpn_levels(jnp.asarray(rois), 4, 10.0, cap, 2.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a 126x1 sliver spans 126 finest cells at its area level 0: the cap
    # moves it one level coarser, and leaves a square box alone
    boxes = torch.tensor([[0, 0.0, 0.0, 126.0, 1.0], [0, 0.0, 0.0, 11.0, 11.0]])
    capped = tra.assign_fpn_levels(boxes, 4, 10.0, CAP, 1.0)
    assert capped.tolist() == [1, 0]
    assert tra.assign_fpn_levels(boxes, 4, 10.0).tolist() == [0, 0]


def test_roi_grid_centers_and_auto_dispatch_on_cpu():
    rois = _rois(seed=7)
    got = tra.roi_grid_centers(torch.from_numpy(rois), (28, 28)).numpy()
    ref = np.asarray(jra.roi_grid_centers(jnp.asarray(rois), (28, 28)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    feats = [torch.from_numpy(f) for f in _pyramid()]
    auto = tra.multilevel_roi_align_auto(
        feats, torch.from_numpy(rois), STRIDES, (7, 7), 10.0, max_ratio=6
    )
    plain = tra.multilevel_roi_align(
        feats, torch.from_numpy(rois), STRIDES, (7, 7), 10.0,
        max_ratio=6, long_span_cap=CAP,
    )
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
