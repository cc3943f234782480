"""``tests/test_torch_fast_presets.py``'s no-CARAFE training step: ``mean_iou``,
the total loss and the gradients, in a file of 3 tests, which xdist hands out
late and before the step's files of 2 (``test_torch_fast_presets_step_*.py``);
JAX's step and the port's are computed once per test run
(``test_torch_fast_presets.py:jax_no_carafe_step``, ``step``).
"""

import numpy as np
import pytest

from test_torch_fast_presets import check_no_carafe_loss, step  # noqa: F401  (the fixture)
from test_torch_train_step import LOSS_CASES, _rel
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", LOSS_CASES[9:])
def test_no_carafe_step_losses_match(step, name):  # noqa: F811
    check_no_carafe_loss(step, name)


def test_no_carafe_step_gradients_match(step):  # noqa: F811
    jg, tg = step["jgrads"], step["tgrads"]
    assert set(jg) == set(tg)
    assert not any("upsample" in p or "conv_up" in p for p in jg)
    bad = {p: e for p in jg if not (e := _rel(tg[p], jg[p])) <= 1e-4}
    assert not bad, bad
    # the NOC decoder trains at 14x14: its final conv has a gradient
    assert np.abs(jg["noc_head/conv_final/kernel"]).any()
