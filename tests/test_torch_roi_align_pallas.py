"""``tests/test_torch_roi_align.py``'s plain version against the sorted and
band Pallas kernels in interpret mode, in a file of at most 3 tests (xdist
hands it out late); that file states the cases and the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import monorun_tpu.ops.roi_align_band as rab
import monorun_tpu.ops.roi_align_sorted as ras

from test_torch_roi_align import STRIDES, TOL, _interpret, _port_align, _pyramid, _rois
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("kernel", ["sorted", "band"])
def test_plain_matches_pallas_kernel(kernel):
    """The TPU kernels that the CUDA kernel replaces, in interpret mode."""
    feats, rois = _pyramid(), _rois(n=8)
    jfeats = [jnp.asarray(f) for f in feats]
    module = ras if kernel == "sorted" else rab
    with _interpret(module):
        if kernel == "sorted":
            ref = jax.jit(lambda f, r: ras.multilevel_roi_align_sorted(
                f, r, STRIDES, (7, 7), 10.0,
                max_ratio=3, kroi=4,
            ))(jfeats, jnp.asarray(rois))
        else:
            ref = jax.jit(lambda f, r: rab.multilevel_roi_align_band(
                f, r, STRIDES, (7, 7), 10.0,
                max_ratio=3, kroi=4,
            ))(jfeats, jnp.asarray(rois))
    got = _port_align(feats, rois, STRIDES, (7, 7), 10.0, 3)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
