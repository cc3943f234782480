"""``tests/test_torch_parallel.py``'s two Gloo ranks: the distributed evaluation,
in a file of at most 2 tests. The ranks run once per test run, built by
``test_torch_parallel_gather.py`` (a file of 3, which xdist hands out first of
these); ``test_torch_parallel.py`` states the setting and the tolerances.
"""

import numpy as np

from monorun_tpu_torch import parallel
from monorun_tpu_torch.data.kitti import KITTI3DDataset

from test_torch_parallel import EVAL_IMAGES, VAL_IMAGES, WORLD, ranks  # noqa: F401
from torch_share import cpu_share  # noqa: F401


def test_each_rank_equals_a_one_process_run_over_its_shard(ranks):
    gathered = ranks["ranks"][0]["eval_results"]
    for r, (results, _) in enumerate(ranks["shard_runs"]):
        shard = set(parallel.dataset_shard(EVAL_IMAGES, r, WORLD).tolist())
        assert {i for i, res in enumerate(results) if res is not None} == shard
        for i in shard:
            for k, v in results[i].items():
                assert np.array_equal(gathered[i][k], v), (i, k)
    for other in ranks["ranks"][1:]:
        for a, b in zip(other["eval_results"], gathered):
            assert all(np.array_equal(a[k], b[k]) for k in b)


def test_distributed_ap_is_evaluate_of_the_gathered_list(ranks):
    ds = KITTI3DDataset(ranks["job"]["eval"]["root"], "train_list.txt")
    want = ds.evaluate(ranks["ranks"][0]["eval_results"], print_summary=False)
    for r in ranks["ranks"]:
        assert list(r["eval_ap"]) == list(want)
        assert all(r["eval_ap"][k] == v for k, v in want.items())
