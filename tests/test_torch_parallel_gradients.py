"""``tests/test_torch_parallel.py``'s two Gloo ranks: the step's gradients, in a
file of at most 2 tests. The ranks run once per test run, built by
``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out first of
these); ``test_torch_parallel.py`` states the setting and the tolerances.
"""

import pytest

from test_torch_parallel import STEPS, ranks  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", STEPS)
def test_gradients_match_the_one_process_step(ranks, name):
    errors = ranks["step_errors"][name]
    assert errors["got_names"] == errors["ref_names"]
    worst = errors["grad_rel"]
    bad = {n: e for n, e in worst.items() if not e <= 1e-5}
    print(f"{name}: worst gradient error {max(worst.values()):.3g} of its leaf's scale "
          f"(allowed 1e-5)")
    assert not bad, bad
    for n, nonzero in errors["zero_leaf_got_any"].items():
        assert not nonzero, n
