"""The fast presets' ``_fast`` rung served by both packages
(``tests/test_torch_fast_presets.py`` states the rung, the inputs, the
draws and the tolerances), in a file of its own of at most 3 tests, which
xdist hands out late (ROADMAP's test-time budget).
"""

import pytest

from test_torch_fast_presets import check_served, serve_rungs
from torch_share import cpu_share  # noqa: F401


@pytest.fixture(scope="module")
def served():
    return serve_rungs(("fast",))


@pytest.mark.parametrize("case", ("fast",))
def test_serve_raw_matches_jax(served, case):
    check_served(*served[case][:2], case)
