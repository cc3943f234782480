"""``tests/test_torch_eval_path.py``'s ``run_eval`` against JAX's,
``inference_detector`` and the distributed run at world size one, in a file of
at most 3 tests (xdist hands it out late); that file states the configuration
and the tolerances.
"""

import numpy as np

from monorun_tpu_torch.apis import inference as tinf
from monorun_tpu_torch.apis.test import run_eval as trun_eval

from test_torch_eval_path import (  # noqa: F401
    B, N_IMAGES, TDataset, _assert_ap_equal, _run_both, _self_labelled,
    assert_result_files_close, assert_results_close, jke, world,
)
from torch_share import cpu_share  # noqa: F401


def test_run_eval_matches_jax(world, tmp_path):  # noqa: F811
    """The closing test: a mini-KITTI through both packages' run_eval on
    the CPU gives the same per-image results, result files and AP dict;
    then again on labels made from those results, where AP is not 0."""
    jds, tds, ap_j, ap_t, jdir, tdir = _run_both(world, world["root"], "random_labels")
    assert len(tds.results) == N_IMAGES and all(r is not None for r in tds.results)
    for i, (got, ref) in enumerate(zip(tds.results, jds.results)):
        assert_results_close(got, ref, f"image {i}")
    assert sum(int(r["valid"].sum()) for r in tds.results) >= N_IMAGES
    assert_result_files_close(tdir, jdir)
    _, ref_ap = jke.kitti_eval([], [], ("Car", "Pedestrian", "Cyclist"))
    assert list(ap_j) == list(ref_ap)
    _assert_ap_equal(ap_t, ap_j)

    root2 = _self_labelled(world["root"], jdir, str(tmp_path / "self_labelled"))
    _, _, ap_j2, ap_t2, _, _ = _run_both(world, root2, "self_labels")
    assert max(ap_j2.values()) > 0.0
    _assert_ap_equal(ap_t2, ap_j2)


def test_inference_detector_equals_run_eval(world):  # noqa: F811
    """The same files through ``inference_detector`` and through
    ``run_eval`` with the same session give the same results (both seed a
    batch with its first index)."""
    sess = world["tsess"]
    ds = TDataset(world["root"], "train_list.txt")
    trun_eval(sess, ds, batch_size=B, print_summary=False, progress=False)
    paths = [ds.image_path(i) for i in range(N_IMAGES)]
    cams = [ds.get_ann(i)["cam_intrinsic"] for i in range(N_IMAGES)]
    got = tinf.inference_detector(sess, paths, cams)
    assert len(got) == N_IMAGES
    for i, (g, r) in enumerate(zip(got, ds.results)):
        for k in ("labels", "bboxes_3d", "valid", "pose_cov"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"image {i} {k}")
        # x 1/test_scale in run_eval, / test_scale here (as in JAX): an ulp
        np.testing.assert_allclose(g["bboxes_2d"], r["bboxes_2d"], rtol=1e-6)
        assert g["scores_2d"].shape == r["valid"].shape


def test_run_eval_distributed_at_world_size_one_is_the_plain_run(world):  # noqa: F811
    """Without a process group the shard is the whole dataset: the same
    batches, seeds, results and AP as ``distributed=False``."""
    runs = []
    for distributed in (False, True):
        ds = TDataset(world["root"], "train_list.txt")
        ap = trun_eval(world["tsess"], ds, batch_size=B, print_summary=False, progress=False,
                       distributed=distributed)
        runs.append((ds.results, ap))
    (plain, ap_plain), (dist, ap_dist) = runs
    assert ap_dist == ap_plain
    assert len(dist) == len(plain) == N_IMAGES
    for a, b in zip(dist, plain):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
