"""``tests/test_torch_pnp.py``'s ``pnp_uncert`` without RANSAC against JAX's,
in a file of at most 3 tests (xdist hands it out late); that file states the
cases and the tolerances.
"""

import pytest

from test_torch_pnp import CASES, check_pnp_uncert
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ransac", [False])
def test_pnp_uncert_matches_jax(case, ransac):
    check_pnp_uncert(case, ransac)
