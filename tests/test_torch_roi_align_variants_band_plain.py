"""``tests/test_torch_roi_align_variants.py``'s band slots against JAX's in
the plain mode, and the lazy level's slivers, in a file of at most 3 tests
(xdist hands it out late); that file states the cases and tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorun_tpu.ops.roi_align_band as jband
from monorun_tpu_torch.ops import roi_align as tra
from monorun_tpu_torch.ops import roi_align_band as tband
from monorun_tpu_torch.ops import roi_align_tile as ttile

from test_torch_roi_align import CAP, TOL, _interpret, _rois
from test_torch_roi_align_variants import CASES, _j, _t, check_band_slots
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("mode", ["plain"])
@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_band_slots_match_jax(out_size, finest, max_ratio, mode):
    check_band_slots(out_size, finest, max_ratio, mode)


def test_lazy_level_slivers_overrun_the_tile():
    """With the lazy lower level the align strides are (4, 4, 8, 16): the
    span cap assumes stride 4 * 2^level, so a sliver at level 1 (stride 4)
    can span more than the 96-column tile. The port's staged version drops
    the taps beyond the window exactly as the JAX band kernel does (an
    inherited fault of the reference, flagged by ``fits``), and agrees with
    the gather version on every RoI that fits."""
    strides = (4, 4, 8, 16)
    feats = [np.random.default_rng(l).normal(size=(2, 128 // s, 512 // s, 32))
             .astype(np.float32) for l, s in enumerate(strides)]
    rois = np.concatenate([_rois(n=8, W=512, H=128, seed=6), np.array(
        [[0, 10.0, 50.0, 480.0, 60.0], [1, 20.0, 30.0, 420.0, 42.0]], np.float32)])
    args = (strides, (7, 7), 20.0)
    geo = ttile.roi_tile_geometry(torch.from_numpy(rois), [f.shape[1:3] for f in feats],
                                  strides, (7, 7), 20.0, 6, 32, 96, torch.float32)
    fits = geo.fits.numpy()
    assert fits[:-2].all() and not fits[-2:].any()
    got = tband.multilevel_roi_align_band(_t(feats), torch.from_numpy(rois), *args,
                                          max_ratio=6, kroi=4).numpy()
    with _interpret(jband):
        ref = jax.jit(lambda f, r: jband.multilevel_roi_align_band(
            f, r, *args, max_ratio=6, kroi=4))(_j(feats), jnp.asarray(rois))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    gather = tra.multilevel_roi_align(_t(feats), torch.from_numpy(rois), *args, max_ratio=6,
                                      long_span_cap=CAP).numpy()
    np.testing.assert_allclose(got[fits], gather[fits], **TOL)
    assert np.abs(got[~fits] - gather[~fits]).max() > 0.1
