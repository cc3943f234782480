"""``tests/test_torch_train_entry.py``'s whole-loop score loss and ``mean_iou``,
in a file of at most 2 tests: xdist hands it out after every file of 3, so
after ``test_torch_train_entry.py``, which builds the reference (``jax_loop``,
``port_loop``), once per run.
"""

import pytest

from test_torch_train_entry import check_loop_loss, parity  # noqa: F401  (the fixture)
from test_torch_train_step import LOSS_CASES
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", LOSS_CASES[8:10])
def test_loop_losses_match_jax(parity, name):  # noqa: F811
    check_loop_loss(parity, name)
