"""``tests/test_torch_eval_path.py``'s per-call seeds, ``tools.test`` with
``tools.prepare_kitti``, and the image demo, in a file of at most 3 tests
(xdist hands it out late); that file states the configuration and the
tolerances.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from monorun_tpu_torch.apis import inference as tinf
from monorun_tpu_torch.data import kitti as tk

from test_torch_eval_path import (  # noqa: F401
    B, N_IMAGES, TINY_OPTIONS, _batch, configs, jax_draws, jke, world,
)
from torch_share import cpu_share  # noqa: F401


def test_run_seed_repeats_and_ignores_call_order(world):  # noqa: F811
    sess = world["tsess"]
    batch = _batch(world["root"])
    args = (batch["images"], batch["cam"], batch["img_shapes"])
    first = sess.run(*args, seed=4)
    sess.run(*args, seed=9)
    again = sess.run(*args, seed=4)
    other = sess.run(*args, seed=9)
    for k in ("bboxes_3d", "pose_cov", "valid"):
        torch.testing.assert_close(getattr(again, k), getattr(first, k), rtol=0, atol=0)
    torch.testing.assert_close(again.extras["latent_vecs"], first.extras["latent_vecs"],
                               rtol=0, atol=0)
    assert not torch.equal(other.pose_cov, first.pose_cov)
    # injected draws win over the seed
    draws = jax_draws(sess.cfg, 1, B)
    a, b = sess.run(*args, seed=4, draws=draws), sess.run(*args, seed=9, draws=draws)
    torch.testing.assert_close(a.pose_cov, b.pose_cov, rtol=0, atol=0)


def test_tools_test_and_prepare_kitti(world, tmp_path):  # noqa: F811
    from monorun_tpu_torch.tools import prepare_kitti, test as tools_test

    root = str(tmp_path / "kitti")
    shutil.copytree(world["root"], root)
    shutil.rmtree(os.path.join(root, "img_metas"))
    assert prepare_kitti.main([root, "train_list.txt"]) == N_IMAGES
    for name in os.listdir(os.path.join(world["root"], "img_metas")):
        with open(os.path.join(root, "img_metas", name)) as f, \
                open(os.path.join(world["root"], "img_metas", name)) as g:
            assert f.read() == g.read()

    summary, results = str(tmp_path / "ap.json"), str(tmp_path / "results")
    argv = ["kitti_multiclass", "--val-set", "--device", "cpu", "--batch-size", "2",
            "--summary-file", summary, "--result-dir", results, "--cfg-options",
            f"data.train_root='{root}'", "data.val_list='train_list.txt'", *TINY_OPTIONS]
    ap = tools_test.main(argv)
    with open(summary) as f:
        assert json.load(f) == ap
    _, ref_ap = jke.kitti_eval([], [], ("Car", "Pedestrian", "Cyclist"))
    assert list(ap) == list(ref_ap) and all(np.isfinite(v) for v in ap.values())
    assert len(os.listdir(results)) == N_IMAGES
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tools_test.main(argv + ["--distributed"])     # not launched by torchrun


def test_demo_infer_imgs_on_cpu(world, tmp_path, monkeypatch):  # noqa: F811
    """The image demo end to end on the CPU, the tiny configuration in
    place of the preset."""
    from monorun_tpu_torch.demo import infer_imgs

    _, tcfg = configs()
    monkeypatch.setattr(tinf, "get_config", lambda name: tcfg)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for name in ("000000.png", "000001.png"):
        shutil.copy(os.path.join(world["root"], "image_2", name), imgs / name)
    calib = tmp_path / "calib.csv"
    np.savetxt(calib, tk.KITTI3DDataset(world["root"], "train_list.txt").get_ann(0)[
        "cam_intrinsic"], delimiter=",")
    out = tmp_path / "viz"
    results = infer_imgs.main([str(imgs), "tiny", "--calib", str(calib), "--device", "cpu",
                               "--show-dir", str(out)])
    assert len(results) == 2 and sorted(os.listdir(out)) == ["000000.png", "000001.png"]
