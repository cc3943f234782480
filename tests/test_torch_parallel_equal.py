"""``tests/test_torch_parallel.py``'s two Gloo ranks: equal state on both ranks
after the step, in a file of at most 2 tests. The ranks run once per test run,
built by ``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out
first of these); ``test_torch_parallel.py`` states the setting and the
tolerances.
"""

import pytest

from test_torch_parallel import STEPS, WORLD, ranks  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", STEPS)
def test_ranks_hold_equal_state_after_the_step(ranks, name):
    """Gradients, parameters, loss_ema and the score statistics bit-equal
    on both ranks (checked over the group in the children)."""
    assert all(r["steps"][name]["same_on_every_rank"] for r in ranks["ranks"])
    assert [r["rank"] for r in ranks["ranks"]] == list(range(WORLD))
