"""``tests/test_torch_roi_align_variants.py``'s tiered union product, in a file
of at most 3 tests (xdist hands it out late); that file states the cases and
tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorun_tpu.ops.roi_align_band as jband
from monorun_tpu_torch.ops import roi_align_band as tband

from test_torch_roi_align import STRIDES, TOL, _interpret, _pyramid, _rois
from test_torch_roi_align_variants import CASES, _j, _t
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_tiered_union_product_matches_plain_and_pallas(out_size, finest, max_ratio):
    """The staged core's zero-extended union-row product (``union_product``)
    on a tiered call, stated in plain PyTorch, against the plain version on
    the same slots and the JAX tiered Pallas kernel in interpret mode; its
    blocks reach past one slot's rows, so the zero extension is exercised."""
    feats, rois = _pyramid(), _rois()
    call = tband.prepare_band_call(_t(feats), torch.from_numpy(rois), STRIDES, out_size,
                                   finest, max_ratio, kroi=4, tiered=True)
    real = call.dst.view(-1, 4) >= 0
    rw0 = call.row0.view(-1, 4)
    assert max(int(r[m].max() - r[m].min()) for r, m in zip(rw0, real) if m.any()) > 0
    got = tband.union_product(call).numpy()
    np.testing.assert_allclose(got, tband.band_call_plain(call).numpy(), **TOL)
    with _interpret(jband):
        ref = jband.multilevel_roi_align_band(_j(feats), jnp.asarray(rois), STRIDES, out_size,
                                              finest, max_ratio=max_ratio, kroi=4, tiered=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
