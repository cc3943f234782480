"""``tests/test_torch_parallel.py``'s two Gloo ranks: the batch-wide reductions
``bn_var`` and ``bn_out``, in a file of at most 2 tests. The ranks run once per
test run, built by ``test_torch_parallel_gather.py`` (a file of 3, which xdist
hands out first of these); ``test_torch_parallel.py`` states the setting and
the tolerances.
"""

import pytest

from test_torch_parallel import UNITS, check_unit, ranks  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("key", UNITS[6:8])
def test_each_batch_wide_reduction_matches(ranks, key):  # noqa: F811
    check_unit(ranks, key)
