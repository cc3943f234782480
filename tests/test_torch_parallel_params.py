"""``tests/test_torch_parallel.py``'s two Gloo ranks: the parameters after the
step, in a file of at most 2 tests. The ranks run once per test run, built by
``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out first of
these); ``test_torch_parallel.py`` states the setting and the tolerances.
"""

import pytest

from test_torch_parallel import STEPS, ranks  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", STEPS)
def test_parameters_after_one_step_match(ranks, name):
    """The step's change of each parameter to 1e-4 of lr where the gradient
    stands above 1e-3 of its leaf's scale; everywhere within 2 lr; both
    plus two roundings of the parameter (the change is read as a difference
    of parameters); ``test_torch_parallel.py:step_errors`` takes the
    errors."""
    for n, (du_err, du_allowed, err, allowed) in ranks["step_errors"][name]["params"].items():
        assert du_err <= du_allowed, (n, du_err, du_allowed)
        assert err <= allowed, (n, err, allowed)
