"""``tests/test_torch_parallel.py``'s two Gloo ranks: the score rows each rank
sees, in a file of at most 2 tests. The ranks run once per test run, built by
``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out first of
these); ``test_torch_parallel.py`` states the setting and the tolerances.
"""

import pytest

from test_torch_parallel import STEPS, ranks  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", STEPS)
def test_each_rank_has_positive_score_rows(ranks, name):
    """The score head's reductions see real rows on every rank."""
    counts = [r["steps"][name]["pose_ok"] for r in ranks["ranks"]]
    assert all(c > 0 for c in counts), counts
    assert sum(counts) == ranks["ref"][name]["pose_ok"]
