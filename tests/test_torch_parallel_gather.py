"""``tests/test_torch_parallel.py``'s two Gloo ranks: ``allgather_results``
against JAX's, and the distributed evaluation's gather, in a file of 3 tests,
which xdist hands out before the files of 2 that read the same ranks: its first
test runs them, once per test run (``test_torch_parallel.py:ranks``);
``test_torch_parallel.py`` states the setting and the tolerances.
"""

import numpy as np
import pytest

from monorun_tpu.parallel import dataset_shard as jdataset_shard

from test_dist_eval import _simulate_multiprocess_gather
from test_torch_parallel import EVAL_IMAGES, WORLD, ranks  # noqa: F401  (the fixture)
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("total", [7, 8])
def test_allgather_results_matches_jax_two_processes(ranks, monkeypatch, total):
    """Each rank's gathered list equals JAX's ``allgather_results`` of rank 0
    under the mocked two processes, field by field and bitwise."""
    rng = np.random.default_rng(total)
    golden = {i: {"boxes": rng.normal(size=(4, 8)).astype(np.float32),
                  "valid": rng.integers(0, 2, size=(4,)).astype(bool)} for i in range(total)}
    local_of_rank = [{int(i): golden[int(i)] for i in jdataset_shard(total, rank=r, world=WORLD)}
                     for r in range(WORLD)]
    want = _simulate_multiprocess_gather(monkeypatch, WORLD, total, local_of_rank)
    for got in (r["gather"][total] for r in ranks["ranks"]):
        assert len(got) == total
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_distributed_eval_gathers_every_index_once(ranks):
    for r in ranks["ranks"]:
        results = r["eval_results"]
        assert len(results) == EVAL_IMAGES and all(res is not None for res in results)
