"""``tests/test_torch_roi_align_variants.py``'s tiled align against JAX's, in a
file of at most 3 tests (xdist hands it out late); that file states the cases
and tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.ops import roi_align as jra
from monorun_tpu_torch.ops import roi_align as tra

from test_torch_roi_align import STRIDES, TOL, _pyramid, _rois
from test_torch_roi_align_variants import _j, _t
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("round_weights", [False, True])
def test_tiled_matches_jax_tiled(round_weights):
    """The plain separable version against the JAX one (float32, where
    rounding the weights to the features' dtype changes nothing), and
    against the gather version without the span cap."""
    feats, rois = _pyramid(), _rois(seed=2)
    got = tra.multilevel_roi_align_tiled(_t(feats), torch.from_numpy(rois), STRIDES,
                                         (7, 7), 10.0, max_ratio=3, tile_hw=(24, 44),
                                         round_weights=round_weights)
    ref = jra.multilevel_roi_align_tiled(_j(feats), jnp.asarray(rois), STRIDES, (7, 7),
                                         10.0, max_ratio=3, tile_hw=(24, 44))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # ordinary boxes (no slivers) are covered by a 24x44 tile at their level
    ok = np.arange(24)
    gather = tra.multilevel_roi_align(_t(feats), torch.from_numpy(rois[ok]), STRIDES,
                                      (7, 7), 10.0, max_ratio=3)
    torch.testing.assert_close(got[ok], gather, **TOL)
