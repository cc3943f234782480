"""The port's PnP solver against the JAX package's, continued from
``tests/test_torch_pnp.py`` in a file of its own of at most 3 tests, which
xdist hands out late (ROADMAP's test-time budget): RANSAC on the JAX
draws. Tolerances as there.
"""

import pytest

from test_torch_pnp import CASES, check_pnp_uncert
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ransac", [True])
def test_pnp_uncert_matches_jax(case, ransac):
    check_pnp_uncert(case, ransac)
