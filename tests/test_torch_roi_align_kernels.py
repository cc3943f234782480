"""Each staged kernel's plain version against the JAX Pallas kernel it
ports, in interpret mode, and the JAX gather oracle; the staged core's
product against the Pallas kernel. ``tests/test_torch_roi_align_variants.py``
states the sizes and tolerances. The kernels are in files of at most 3
tests, which xdist hands out late (ROADMAP's test-time budget): the tile
and plain ones here, the band kernels in
``test_torch_roi_align_kernels_band.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorun_tpu.ops.roi_align_band as jband
import monorun_tpu.ops.roi_align_pallas as jtile
from monorun_tpu.ops import roi_align as jra
from monorun_tpu_torch.ops import roi_align_band as tband
from monorun_tpu_torch.ops import roi_align_tile as ttile

from test_torch_roi_align import CAP, STRIDES, TOL, _interpret, _pyramid, _rois
from test_torch_roi_align_variants import MODES, _j, _t
from torch_share import cpu_share  # noqa: F401


def check_plain_versions(variant):
    """Each staged kernel's plain version on the port's slots against the
    JAX Pallas kernel in interpret mode and the JAX gather oracle; the
    staged core's product (``union_product``) against the Pallas kernel."""
    feats, rois = _pyramid(), _rois()
    out_size, finest, max_ratio = (7, 7), 10.0, 3
    if variant == "tile":
        call = ttile.prepare_tile_call(_t(feats), torch.from_numpy(rois), STRIDES,
                                       out_size, finest, max_ratio)
        got = ttile.run_tile_call(call).numpy()
        with _interpret(jtile):
            ref = jax.jit(lambda f, r: jtile.multilevel_roi_align_pallas(
                f, r, STRIDES, out_size, finest,
                max_ratio=max_ratio, kroi=1))(   # interpret mode: kroi=1 traces fastest
                _j(feats), jnp.asarray(rois))
    else:
        call = tband.prepare_band_call(_t(feats), torch.from_numpy(rois), STRIDES,
                                       out_size, finest, max_ratio, kroi=4,
                                       **MODES[variant])
        got = tband.run_band_call(call).numpy()
        with _interpret(jband):
            ref = jband.multilevel_roi_align_band(
                _j(feats), jnp.asarray(rois), STRIDES, out_size, finest,
                max_ratio=max_ratio, kroi=4, **MODES[variant])
    oracle = jax.jit(lambda f, r: jra.multilevel_roi_align(
        f, r, STRIDES, out_size, finest, sampling_ratio=0, max_ratio=max_ratio,
        long_span_cap=CAP))(_j(feats), jnp.asarray(rois))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    if variant != "plain":
        # the staged core's product (csrc/roi_align_ring.cuh) on the same slots
        np.testing.assert_allclose(tband.union_product(call).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", ["tile", "plain"])
def test_plain_versions_match_pallas_kernels(variant):
    check_plain_versions(variant)
