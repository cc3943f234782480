"""``tests/test_torch_roi_align_variants.py``'s band variants against the
gather version, in a file of at most 3 tests (xdist hands it out late); that
file states the cases and tolerances.
"""

import pytest
import torch

from monorun_tpu_torch.ops import roi_align as tra
from monorun_tpu_torch.ops import roi_align_band as tband
from monorun_tpu_torch.ops import roi_align_tile as ttile

from test_torch_roi_align import CAP, STRIDES, TOL, _pyramid, _rois
from test_torch_roi_align_variants import CASES, MODES, _t
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_band_variants_match_gather(out_size, finest, max_ratio):
    """Every band mode and the tile version through the public functions
    (plain versions on the CPU) against the port's gather version, and the
    bfloat16 row product of the matmul variant within one rounding of t1."""
    feats, rois = _t(_pyramid()), torch.from_numpy(_rois(seed=4))
    ref = tra.multilevel_roi_align(feats, rois, STRIDES, out_size, finest,
                                   max_ratio=max_ratio, long_span_cap=CAP)
    for mode, kw in MODES.items():
        got = tband.multilevel_roi_align_band(feats, rois, STRIDES, out_size, finest,
                                              max_ratio=max_ratio, kroi=4, **kw)
        torch.testing.assert_close(got, ref, **TOL, msg=mode)
    got = ttile.multilevel_roi_align_tile(feats, rois, STRIDES, out_size, finest, max_ratio)
    torch.testing.assert_close(got, ref, **TOL)
    # t1 in bfloat16: |t1| <= max|x| and the X weights of a row sum to at
    # most 1, so one rounding of t1 moves the output by <= 2^-8 max|x|
    got = tband.multilevel_roi_align_band(feats, rois, STRIDES, out_size, finest,
                                          max_ratio=max_ratio, kroi=4, matmul=True,
                                          t1_dtype=torch.bfloat16)
    bound = 2 ** -8 * max(float(f.abs().max()) for f in feats)
    assert float((got - ref).abs().max()) <= bound
