"""``tests/test_torch_train_step.py``'s total loss, ``loss_ema`` and score
statistics, in a file of at most 2 tests: xdist hands it out after every file
of 3, so after ``test_torch_train_step.py``, which builds the reference
(``jax_step``, ``port_step``), once per run.
"""

import numpy as np
import pytest

from test_torch_train_step import LOSS_CASES, _rel, both, check_loss  # noqa: F401
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", LOSS_CASES[10:])
def test_losses_match(both, name):  # noqa: F811
    check_loss(both, name)


def test_loss_ema_and_score_statistics_match(both):  # noqa: F811
    np.testing.assert_allclose(float(both["tema"]), float(both["jema"]), rtol=1e-6)
    for path, ref in both["jstats"].items():
        assert _rel(both["tstats"][path], ref) < 1e-3, path
