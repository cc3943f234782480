"""``tests/test_torch_parallel.py``'s two Gloo ranks: the score head on the card's
captured rows, in a file of at most 2 tests. The ranks run once per test run,
built by ``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out
first of these); ``test_torch_parallel.py`` states the setting and the
tolerances.
"""

import pytest

from test_torch_parallel import SCORE_DTYPES, WORLD, _rel, ranks  # noqa: F401
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("dtype", SCORE_DTYPES)
def test_score_head_on_captured_rows_matches_one_process(ranks, dtype):
    """The card's ill-conditioned score rows: every rank holds the one
    process's loss, gradients and running statistics."""
    ref = ranks["score_rows"][dtype]
    rows = ranks["job"]["score_rows"]["rows"]
    assert [int((rows["rank"] == r).sum()) for r in range(WORLD)] == [10, 13]
    assert float(rows["pose_cov"].abs().max()) > 4e4
    for r, got in enumerate(rank["score_rows"][dtype] for rank in ranks["ranks"]):
        errs = {n: _rel(got["grads"][n], g) for n, g in ref["grads"].items()}
        errs.update({k: _rel(got[k], ref[k]) for k in ("loss", "running_mean", "running_var")})
        print(f"rank {r} {dtype}: the score head within {max(errs.values()):.3g} of its scale")
        assert max(errs.values()) <= SCORE_DTYPES[dtype], (r, errs)
