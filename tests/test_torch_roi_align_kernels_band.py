"""``tests/test_torch_roi_align_kernels.py``'s band kernels (tiered, packed and
matmul), in a file of at most 3 tests (xdist hands it out late); that file
states the check.
"""

import pytest

from test_torch_roi_align_kernels import check_plain_versions
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("variant", ["tiered", "packed", "matmul"])
def test_plain_versions_match_pallas_kernels(variant):
    check_plain_versions(variant)
