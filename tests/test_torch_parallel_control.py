"""``tests/test_torch_parallel.py``'s two Gloo ranks: the negative control without
global sums, in a file of at most 2 tests. The ranks run once per test run,
built by ``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out
first of these); ``test_torch_parallel.py`` states the setting and the
tolerances.
"""

from test_torch_parallel import WORLD, _rel, _unit_errors, ranks
from torch_share import cpu_share  # noqa: F401


def test_negative_control_without_global_sums_fails(ranks):
    """With ``global_sum`` the identity in the ranks, every unit reduction
    and the step's losses and statistics miss the one-process values."""
    errs = _unit_errors(ranks, "control_units")
    assert all(e > 1e-3 for e in errs.values()), errs
    ref = ranks["ref"]["plain"]
    ctl = [r["control_step"] for r in ranks["ranks"]]
    loss_errs = {k: abs(sum(c["metrics"][k] for c in ctl) / WORLD - v) / max(abs(v), 1e-12)
                 for k, v in ref["metrics"].items() if k.startswith("loss") and v}
    print(f"negative control: losses off by up to {max(loss_errs.values()):.3g}")
    assert max(loss_errs.values()) > 1e-3
    assert abs(float(ctl[0]["loss_ema"]) - float(ctl[1]["loss_ema"])) > 0
    assert _rel(ctl[0]["bn"]["mean"], ref["bn"]["mean"]) > 1e-3
