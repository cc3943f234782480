"""``tests/test_torch_train_step.py``'s RPN losses, in a file of at most 2 tests:
xdist hands it out after every file of 3, so after
``test_torch_train_step.py``, which builds the reference (``jax_step``,
``port_step``), once per run.
"""

import pytest

from test_torch_train_step import LOSS_CASES, both, check_loss  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", LOSS_CASES[0:2])
def test_losses_match(both, name):  # noqa: F811
    check_loss(both, name)
