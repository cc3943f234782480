"""``tests/test_torch_roi_align_variants.py``'s band slots against JAX's in
the tiered mode, in a file of at most 3 tests (xdist hands it out
late); that file states the cases and tolerances.
"""

import pytest

from test_torch_roi_align_variants import CASES, check_band_slots
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("mode", ["tiered"])
@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_band_slots_match_jax(out_size, finest, max_ratio, mode):
    check_band_slots(out_size, finest, max_ratio, mode)
