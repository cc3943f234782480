"""``tests/test_torch_roi_align_merge.py``'s merged taps against the JAX align,
in a file of at most 3 tests (xdist hands it out late); that file states the
cases and the tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from monorun_tpu.ops import roi_align as jra

from test_torch_roi_align_merge import CAP, CASES, STRIDES, _pyramid, _rebuild, _rois, _taps
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_merged_taps_rebuild_the_jax_align(out_size, finest, max_ratio):
    feats, rois = _pyramid(), _rois()
    got = _rebuild(feats, _taps(rois, out_size, finest, max_ratio)).numpy()
    ref = np.asarray(jra.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES, out_size, finest,
        sampling_ratio=0, max_ratio=max_ratio, long_span_cap=CAP))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
