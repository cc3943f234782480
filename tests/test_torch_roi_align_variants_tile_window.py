"""``tests/test_torch_roi_align_variants.py``'s tile geometry against JAX's
with the row window, in a file of at most 3 tests (xdist hands it out
late); that file states the cases and tolerances.
"""

import pytest

from test_torch_roi_align_variants import CASES, check_tile_geometry
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("row_window", [True])
@pytest.mark.parametrize("out_size,finest,max_ratio", CASES)
def test_tile_geometry_matches_jax(out_size, finest, max_ratio, row_window):
    check_tile_geometry(out_size, finest, max_ratio, row_window)
