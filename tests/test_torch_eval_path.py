"""The evaluation path, port against JAX, at a tiny configuration.

The tiny float32 configuration of ``test_torch_serve.py`` (ResNet-26,
64-wide neck, 2 MC samples, 6 of 12 head slots, the debug maps on) with
``test_scale`` 0.1, so ``make_mini_kitti``'s 375x1242 images go through
the host downscale into a 64x128 pad; the JAX weights (non-trivial
values) carried over by ``from_jax_params``. Where the two packages meet,
the port is given the JAX draws: a test-side wrapper of the port
session's ``run`` turns each call's seed into the MC-dropout masks and
RANSAC keys that ``jax.random.PRNGKey(seed)`` gives the JAX session.

Tolerances as in ``test_torch_serve.py``: labels and validity masks
exact; 2D boxes to 1e-5 of their scale; 3D boxes, covariances and debug
maps to 1e-3. Result files are compared field by field at the same
tolerances (they print 6 decimals), AP dicts to 1e-9.

The cases that run both sessions are in
``test_torch_eval_path_{forward,run_eval,tools}.py``: files of at most 3 tests,
which xdist hands out late (ROADMAP's test-time budget).
"""

import dataclasses
import importlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from fixtures import make_mini_kitti
from monorun_tpu.apis import inference as jinf
from monorun_tpu.apis.test import run_eval as jrun_eval
from monorun_tpu.config import get_config
from monorun_tpu.data import kitti as jk
from monorun_tpu.data.pipeline import collate as jcollate
from monorun_tpu.data.pipeline import prepare_test_sample as jprepare
from monorun_tpu_torch.apis import inference as tinf
from monorun_tpu_torch.apis.test import run_eval as trun_eval
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.data import kitti as tk
from monorun_tpu_torch.models.detector import HeadDraws, MonoRUn
from monorun_tpu_torch.utils.weights import from_jax_params

from test_torch_modules import jax_mc_masks
from test_torch_serve import H, W, jax_variables, tiny_config
from torch_share import cpu_share  # noqa: F401

B = 2
N_IMAGES = 5          # batches of 2: the last one wraps to the front
TEST_SCALE = 0.1      # 375x1242 -> 38x124, inside the 64x128 pad
jke = importlib.import_module("monorun_tpu.eval.kitti_eval")


def configs():
    def cfg(get):
        c = tiny_config(get)
        return dataclasses.replace(c, data=dataclasses.replace(c.data, test_scale=TEST_SCALE))
    return cfg(get_config), cfg(tget_config)


class JaxDraws:
    """The port session, given on each call the draws that the JAX session
    takes from ``PRNGKey(seed)`` (``heads_forward`` splits it into the MC
    and the PnP keys)."""

    def __init__(self, session):
        self.session = session
        self.cfg = session.cfg
        self.batch_size = session.batch_size

    def run(self, images, cam, shapes, seed=0):
        return self.session.run(images, cam, shapes, seed=seed,
                                draws=jax_draws(self.cfg, seed, len(images)))


def jax_draws(cfg, seed, batch):
    rng_mc, rng_pnp = jax.random.split(jax.random.PRNGKey(seed))
    n = batch * cfg.test.head_slots
    masks = jax_mc_masks(cfg.global_head, rng_mc, n, cfg.neck.out_channels)
    keys = np.array(jax.random.uniform(
        rng_pnp, (n, cfg.pose_head.ransac_hypotheses, cfg.noc_head.dense_size ** 2)))
    return HeadDraws(tuple(torch.from_numpy(m.copy()) for m in masks),
                     torch.from_numpy(keys))


class Recording:
    """A dataset that keeps the per-image results ``evaluate`` is given."""

    def evaluate(self, results, **kw):
        self.results = results
        return super().evaluate(results, **kw)


class JDataset(Recording, jk.KITTI3DDataset):
    pass


class TDataset(Recording, tk.KITTI3DDataset):
    pass


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_kitti"))
    make_mini_kitti(root, n_images=N_IMAGES, seed=1)
    jcfg, tcfg = configs()
    variables = jax_variables(jcfg)
    jsess = jinf.InferenceSession(jcfg, variables, batch_size=B)
    model = MonoRUn(tcfg)
    model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    tsess = tinf.InferenceSession(tcfg, model, B, torch.device("cpu"))
    return dict(root=root, jsess=jsess, tsess=tsess, out=tmp_path_factory.mktemp("out"))


def _close(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-6)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


TOL = dict(bboxes_2d=1e-5, scores_2d=1e-5, bboxes_3d=1e-3, pose_cov=1e-3,
           oc_maps=1e-3, std_maps=1e-3, latent_vecs=1e-3)


def assert_results_close(got, ref, what=""):
    assert sorted(got) == sorted(ref), what
    np.testing.assert_array_equal(got["valid"], ref["valid"], err_msg=what)
    np.testing.assert_array_equal(got["labels"], ref["labels"], err_msg=what)
    for k in ref:
        if k not in ("valid", "labels"):
            _close(got[k], ref[k], TOL[k], f"{what} {k}")


def _batch(root):
    ds = jk.KITTI3DDataset(root, "train_list.txt")
    jcfg, _ = configs()
    return jcollate([jprepare(ds, i, jcfg.data) for i in range(B)])


def _run_both(world, root, tag):
    """Both packages' run_eval on ``root``: (jax ds, port ds, ap_j, ap_t,
    result dirs)."""
    jds, tds = JDataset(root, "train_list.txt"), TDataset(root, "train_list.txt")
    jdir, tdir = str(world["out"] / f"{tag}_jax"), str(world["out"] / f"{tag}_port")
    ap_j = jrun_eval(world["jsess"], jds, batch_size=B, result_dir=jdir,
                     print_summary=False, progress=False)
    ap_t = trun_eval(JaxDraws(world["tsess"]), tds, batch_size=B, result_dir=tdir,
                     print_summary=False, progress=False)
    return jds, tds, ap_j, ap_t, jdir, tdir


def _result_lines(path):
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines()]


def assert_result_files_close(tdir, jdir):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and len(names) == N_IMAGES
    for name in names:
        got, ref = _result_lines(os.path.join(tdir, name)), _result_lines(os.path.join(jdir, name))
        assert len(got) == len(ref), name
        for g, r in zip(got, ref):
            assert g[:3] == r[:3], name                   # class, truncated, occluded
            vals_g, vals_r = np.float64(g[3:]), np.float64(r[3:])
            _close(vals_g[1:5], vals_r[1:5], 1e-5, name)   # 2D box
            _close(vals_g[[0] + list(range(5, 13))], vals_r[[0] + list(range(5, 13))],
                   1e-3, name)                              # alpha, 3D box, score


def _assert_ap_equal(ap_t, ap_j):
    assert list(ap_t) == list(ap_j)
    for k, v in ap_j.items():
        assert abs(ap_t[k] - v) <= 1e-9, (k, ap_t[k], v)


def _self_labelled(root, result_dir, dest):
    """A copy of the mini-KITTI whose labels are the given result files
    (the same column layout, plus the score), so the detections are true
    positives and the AP is not 0 (with a handful of objects per class,
    R40 stays low: 3 objects fill 2 of its 40 recall points)."""
    shutil.copytree(root, dest)
    for name in os.listdir(result_dir):
        shutil.copy(os.path.join(result_dir, name), os.path.join(dest, "label_2", name))
    return dest


def test_read_calib_csv(tmp_path):
    path = tmp_path / "calib.csv"
    np.savetxt(path, np.array([[721.5377, 0, 609.5593], [0, 721.5377, 172.854], [0, 0, 1]]),
               delimiter=",")
    got, ref = tinf.read_calib_csv(str(path)), jinf.read_calib_csv(str(path))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_pth_lazy_lower_rule(tmp_path):
    """A reference .pth switches neck.lazy_lower off unless the caller set
    it (explicit_lazy); nothing else does (the JAX package's rule). A
    checkpoint of the port's training loop loads with its weights and
    serves; a missing one raises."""
    _, tcfg = configs()
    assert tcfg.neck.lazy_lower
    assert tinf.serving_config(tcfg, None).neck.lazy_lower
    assert tinf.serving_config(tcfg, "run/step_100").neck.lazy_lower
    assert not tinf.serving_config(tcfg, "w.pth").neck.lazy_lower
    assert tinf.serving_config(tcfg, "w.pth", explicit_lazy=True).neck.lazy_lower
    dense = dataclasses.replace(tcfg, neck=dataclasses.replace(tcfg.neck, lazy_lower=False))
    assert not tinf.serving_config(dense, "w.pth", explicit_lazy=True).neck.lazy_lower

    ckpt = str(tmp_path / "w.pth")
    torch.save({"state_dict": MonoRUn(tcfg).state_dict()}, ckpt)
    assert not tinf.init_inference(tcfg, ckpt, device="cpu").cfg.neck.lazy_lower
    assert tinf.init_inference(tcfg, ckpt, device="cpu",
                               explicit_lazy=True).cfg.neck.lazy_lower
    # a checkpoint of the port's training loop loads (lazy level kept) and serves
    from monorun_tpu_torch.train import TrainState, make_optimizer
    from monorun_tpu_torch.utils.checkpoint import save_checkpoint

    model = MonoRUn(tcfg)
    with pytest.raises(FileNotFoundError):
        tinf.init_inference(tcfg, str(tmp_path / "step_100"), device="cpu")
    step = save_checkpoint(str(tmp_path), model, make_optimizer(tcfg, model, 10),
                           TrainState(100, torch.ones(())), 100)
    sess = tinf.init_inference(tcfg, step, device="cpu")
    assert sess.cfg.neck.lazy_lower
    served = sess.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(served[k].to(v.dtype), v), k
    det = sess.run(np.zeros((1, H, W, 3), np.float32),
                   np.eye(3, dtype=np.float32)[None] * [[70.0], [70.0], [1.0]],
                   np.array([[H, W]], np.float32))
    assert bool(torch.isfinite(det.bboxes_2d).all())
    shutil.rmtree(step)


TINY_OPTIONS = [
    "compute_dtype='float32'", "backbone.depth=26", "neck.out_channels=64",
    "rpn.feat_channels=64", "bbox_head.fc_out_channels=128",
    "global_head.mc_samples=2", "global_head.fc_out_channels=128",
    "noc_head.conv_out_channels=64", "noc_head.carafe_compressed_channels=16",
    "noc_head.roi_size=8", "noc_head.dense_size=16",
    "score_head.reg_fc_out_channels=128", "score_head.pose_fc_out_channels=128",
    "score_head.fc_out_channels=64", "pose_head.ransac_hypotheses=4",
    "test.rpn_nms_pre=64", "test.rpn_nms_post=64", "test.max_per_img=12",
    "test.head_slots=6", f"data.pad_height={H}", f"data.pad_width={W}",
    f"data.test_scale={TEST_SCALE}",
]


@pytest.mark.parametrize("module", ["infer_imgs", "infer_webcam"])
def test_demo_help(module, capsys):
    demo = importlib.import_module(f"monorun_tpu_torch.demo.{module}")
    with pytest.raises(SystemExit) as e:
        demo.main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out
