"""``tests/test_torch_train_modules.py``'s IoU-balanced sample weights with
the smoothed keep rate, in a file of at most 3 tests (xdist hands it out
late); that file states the tolerances and holds the unsmoothed cases.
"""

import pytest

from test_torch_train_modules import check_iou3d_balanced_sample_weights
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("smooth", [True])
@pytest.mark.parametrize("mix", ["balanced", "many_pos", "many_neg"])
def test_iou3d_balanced_sample_weights(smooth, mix):
    check_iou3d_balanced_sample_weights(smooth, mix)
