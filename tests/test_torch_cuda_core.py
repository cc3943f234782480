"""``tests/test_torch_cuda.py``'s heaviest edge cases of the staged core on the
CPU, in a file of at most 3 tests (xdist hands it out late); that file states
the cases.
"""

import pytest

from test_torch_cuda import HEAVY_CORE_CASES, check_core_case
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("case", HEAVY_CORE_CASES)
def test_core_cases_hold_on_cpu(case):
    check_core_case(case)
