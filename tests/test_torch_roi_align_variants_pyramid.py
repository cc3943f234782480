"""``tests/test_torch_roi_align_variants.py``'s flat pyramid, in a file of at
most 3 tests (xdist hands it out late); that file states the cases and
tolerances.
"""

import numpy as np
import pytest

import monorun_tpu.ops.roi_align_pallas as jtile
from monorun_tpu_torch.ops import roi_align_tile as ttile

from test_torch_roi_align import _pyramid
from test_torch_roi_align_variants import _j, _t
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("width", [128, 192])
def test_flat_pyramid_matches_jax(width):
    """Padded buffers, and at width 192 the zero-copy fast path of the
    32x96 level."""
    feats = _pyramid(W=width)
    tfeats = _t(feats)
    got = ttile.prepare_flat_pyramid(tfeats)
    bufs, sizes, B = jtile.prepare_flat_pyramid(_j(feats))
    assert got.sizes == sizes and got.batch == B
    assert len(got.bufs) == len(bufs) == 2 * len(feats)
    for a, b in zip(got.bufs, bufs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.shape[0] >= ttile.GUARD_ROWS
    # the 32x96 level is its own row-major buffer, without a copy
    zero_copy = got.bufs[0].data_ptr() == tfeats[0].data_ptr()
    assert zero_copy == (width == 192)
