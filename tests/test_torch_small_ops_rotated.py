"""``tests/test_torch_small_ops.py``'s aligned rotated IoU against JAX's for
three of its criteria (the last in ``test_torch_small_ops_iou3d.py``), in a
file of at most 3 tests (xdist hands it out late); that file states the
tolerances.
"""

import pytest

from test_torch_small_ops import check_rotated_iou_aligned
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotated_iou_aligned_matches_jax(criterion):
    check_rotated_iou_aligned(criterion)
