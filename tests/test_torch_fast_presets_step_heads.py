"""``tests/test_torch_fast_presets.py``'s no-CARAFE step: the dimension and NOC
losses, in a file of at most 2 tests: xdist hands it out after every file of 3,
so after ``test_torch_fast_presets_step.py``, which builds the reference
(``jax_no_carafe_step``, ``step``), once per run.
"""

import pytest

from test_torch_fast_presets import check_no_carafe_loss, step  # noqa: F401  (the fixture)
from test_torch_train_step import LOSS_CASES
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", LOSS_CASES[4:6])
def test_no_carafe_step_losses_match(step, name):  # noqa: F811
    check_no_carafe_loss(step, name)
