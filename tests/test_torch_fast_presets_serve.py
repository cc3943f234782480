"""The fast presets' ``_fast2`` and ``_fast3_r50`` rungs served by both
packages (``tests/test_torch_fast_presets.py`` states the rungs, the
inputs, the draws and the tolerances), in a file of at most 3 tests, which
xdist hands out late (ROADMAP's test-time budget): ``serve_raw`` against
JAX's. JAX serves each rung once per test run (``serve_jax``); the no-CARAFE
maps and the port's align switch in the served forward are in
``test_torch_fast_presets_serve_maps.py``.
"""

import pytest

from test_torch_fast_presets import check_served, serve_rungs
from torch_share import cpu_share  # noqa: F401


@pytest.fixture(scope="module")
def served():
    return serve_rungs(("fast2", "fast3_r50"))


@pytest.mark.parametrize("case", ("fast2", "fast3_r50_at", "fast3_r50_below"))
def test_serve_raw_matches_jax(served, case):
    check_served(*served[case][:2], case)
