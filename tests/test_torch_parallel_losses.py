"""``tests/test_torch_parallel.py``'s two Gloo ranks: the step's losses, in a file
of at most 2 tests. The ranks run once per test run, built by
``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out first of
these); ``test_torch_parallel.py`` states the setting and the tolerances.
"""

import numpy as np
import pytest

from test_torch_parallel import STEPS, WORLD, _rel, _unit_errors, ranks  # noqa: F401
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("name", STEPS)
def test_losses_match_the_one_process_step(ranks, name):
    ref = ranks["ref"][name]["metrics"]
    got = [r["steps"][name]["metrics"] for r in ranks["ranks"]]
    assert all(g == got[0] for g in got), "the ranks logged different metrics"
    errs = {k: abs(got[0][k] - v) / max(abs(v), 1e-12) for k, v in ref.items()
            if k != "nonfinite_grad_leaves"}
    print(f"{name}: worst loss relative error {max(errs.values()):.3g} (allowed 1e-5)")
    for k, v in ref.items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-5, atol=1e-12, err_msg=k)
    if name == "scene_debug":
        assert ref["mean_iou"] > 0.1
