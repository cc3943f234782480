"""``tests/test_torch_roi_align_grad.py``'s plain gradients against
``jax.grad`` in its case 1 (7x7, coarse), in a file of at most 3
tests (xdist hands it out late); that file states the tolerances.
"""

import pytest

from test_torch_roi_align_grad import GRAD_CASES, check_plain_gradients
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("out_size,finest,max_ratio", GRAD_CASES[1:2])
def test_plain_gradients_match_jax_grad(seed, out_size, finest, max_ratio):
    check_plain_gradients(seed, out_size, finest, max_ratio)
