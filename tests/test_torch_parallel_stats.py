"""``tests/test_torch_parallel.py``'s two Gloo ranks: ``loss_ema`` and the score
statistics after the step, in a file of at most 2 tests. The ranks run once per
test run, built by ``test_torch_parallel_gather.py`` (a file of 3, which xdist
hands out first of these); ``test_torch_parallel.py`` states the setting and
the tolerances.
"""

import numpy as np
import pytest

from test_torch_parallel import STEPS, _rel, ranks  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", STEPS)
def test_loss_ema_and_score_statistics_match(ranks, name):
    ref = ranks["ref"][name]
    for r in ranks["ranks"]:
        got = r["steps"][name]
        np.testing.assert_allclose(float(got["loss_ema"]), float(ref["loss_ema"]), rtol=1e-6)
        for k in ("mean", "var"):
            assert _rel(got["bn"][k], ref["bn"][k]) <= 1e-3, k
    moved = ref["bn"]["mean"].abs().max() > 0
    assert moved, "the score BatchNorm's statistics did not move"
