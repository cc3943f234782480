"""``tests/test_torch_parallel.py``'s two Gloo ranks: the training loop's
validation on every rank, in a file of at most 2 tests. The ranks run once per
test run, built by ``test_torch_parallel_gather.py`` (a file of 3, which xdist
hands out first of these); ``test_torch_parallel.py`` states the setting and
the tolerances.
"""

import numpy as np

from test_torch_parallel import VAL_IMAGES, ranks
from torch_share import cpu_share  # noqa: F401


def test_train_detector_validates_on_every_rank(ranks):
    """``train_detector``'s validation at two ranks: each rank detects one
    of the two batches of 2 that a one-process run makes, with that run's
    seed (the batch's first index), and the AP that rank 0 alone logs,
    and every rank evaluated, is a one-process ``_run_val``'s on the same
    weights, per-image results bitwise."""
    loops = [r["val_loop"] for r in ranks["ranks"]]
    assert [v["runs"] for v in loops] == [[(0, 2)], [(2, 2)]]
    assert [len(v["logged"]) for v in loops] == [1, 0]
    step, ap = loops[0]["logged"][0]
    results, want = ranks["val_ref"]
    assert step == 1 and list(ap) == list(want) and ap == want
    assert sum(int(r["valid"].sum()) for r in results) >= VAL_IMAGES
    for v in loops:
        (gathered,) = v["results"]
        assert len(gathered) == len(results) == VAL_IMAGES
        for got, ref in zip(gathered, results):
            assert sorted(got) == sorted(ref)
            assert all(np.array_equal(got[k], ref[k]) for k in ref)
