"""The port's data layer against the JAX package's, on one mini-KITTI.

Both are numpy code, so every array is held equal exactly (values and
dtypes): the KITTI parsing and result formatting (``data/kitti.py``), the
host half of ``data/pipeline.py`` (test and train samples on the same
``np.random.default_rng`` seed, ``collate``), the geometric transforms
and ``PrefetchLoader``'s order, tail wrap and ``indices``. One more test
holds the port's loader repair: an exception raised while a batch is
prepared reaches the consumer.
"""

import dataclasses
import filecmp
import os
import threading

import numpy as np
import pytest

from fixtures import make_mini_kitti
from monorun_tpu.config import get_config as jget_config
from monorun_tpu.data import kitti as jk
from monorun_tpu.data import loader as jl
from monorun_tpu.data import pipeline as jp
from monorun_tpu.data import transforms as jt
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.data import kitti as tk
from monorun_tpu_torch.data import loader as tl
from monorun_tpu_torch.data import pipeline as tp
from monorun_tpu_torch.data import transforms as tt

from test_torch_eval import jax_native_built  # noqa: F401  (autouse)
from torch_share import cpu_share  # noqa: F401

N_IMAGES = 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_kitti"))
    make_mini_kitti(root, n_images=N_IMAGES, seed=3)
    return root


def datasets(root, **kw):
    return (jk.KITTI3DDataset(root, "train_list.txt", **kw),
            tk.KITTI3DDataset(root, "train_list.txt", **kw))


def assert_same(got, ref, where=""):
    """Equal structure, values and dtypes."""
    if isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            assert_same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref, where


def data_cfgs(**kw):
    return (dataclasses.replace(jget_config("kitti_multiclass").data, **kw),
            dataclasses.replace(tget_config("kitti_multiclass").data, **kw))


def fake_results(n, seed=0, with_none=()):
    """Fixed-shape detector outputs, as run_eval hands them to evaluate."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i in with_none:
            out.append(None)
            continue
        M = 6
        b2 = rng.uniform(0, 300, (M, 2))
        out.append(dict(
            bboxes_2d=np.concatenate([b2, b2 + rng.uniform(10, 80, (M, 2))], 1
                                     ).astype(np.float32),
            labels=rng.integers(0, 3, M).astype(np.int32),
            bboxes_3d=np.concatenate([
                rng.uniform(1, 4, (M, 3)), rng.uniform(-5, 5, (M, 2)),
                rng.uniform(5, 40, (M, 1)), rng.uniform(-3, 3, (M, 1)),
                rng.uniform(0, 1, (M, 1))], 1).astype(np.float32),
            valid=rng.uniform(size=M) < 0.6,
            pose_cov=np.tile(np.eye(4, dtype=np.float32), (M, 1, 1)),
        ))
    return out


def test_get_ann_and_sparse_coords(root):
    jds, tds = datasets(root, coord_3d_prefix="obj_crd")
    assert len(tds) == len(jds) == N_IMAGES
    for i in range(N_IMAGES):
        assert tds.image_path(i) == jds.image_path(i)
        assert tds.image_size(i) == jds.image_size(i)
        ann = jds.get_ann(i)
        assert_same(tds.get_ann(i), ann, f"ann {i}")
        assert_same(tds.get_sparse_coords(i, ann["object_ids"]),
                    jds.get_sparse_coords(i, ann["object_ids"]), f"coords {i}")
    jnl, tnl = datasets(root, with_labels=False)
    assert_same(tnl.get_ann(0), jnl.get_ann(0))
    assert tk.KITTI_CLASSES == jk.KITTI_CLASSES


def test_calib_and_label_readers(root):
    calib = os.path.join(root, "calib", "000001.txt")
    label = os.path.join(root, "label_2", "000001.txt")
    for cam in range(4):
        assert_same(tk.read_calib(calib, cam), jk.read_calib(calib, cam))
    assert tk.read_label(label) == jk.read_label(label)
    P = jk.read_calib(calib)
    assert_same(tk.decompose_calib(P), jk.decompose_calib(P))


def test_format_results_and_gt_annos(root):
    jds, tds = datasets(root)
    results = fake_results(N_IMAGES, with_none=(2,))
    assert_same(tds.format_results(results), jds.format_results(results))
    assert_same(tds.format_gt_annos(), jds.format_gt_annos())


def test_write_result_files_byte_equal(root, tmp_path):
    jds, tds = datasets(root)
    results = fake_results(N_IMAGES, seed=1, with_none=(0,))
    jds.write_result_files(jds.format_results(results), str(tmp_path / "jax"))
    tds.write_result_files(tds.format_results(results), str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == N_IMAGES
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", names,
                                           shallow=False)
    assert not mismatch and not errors


def test_evaluate_matches(root, tmp_path):
    jds, tds = datasets(root)
    results = fake_results(N_IMAGES, seed=2)
    ap_j = jds.evaluate(results, print_summary=False)
    ap_t = tds.evaluate(results, print_summary=False)
    assert list(ap_t) == list(ap_j) and ap_t == ap_j


def test_prepare_meta_files(root):
    n_j = jk.prepare_meta_files(root, "train_list.txt", out_prefix="meta_jax")
    n_t = tk.prepare_meta_files(root, "train_list.txt", out_prefix="meta_port")
    assert n_t == n_j == N_IMAGES
    names = sorted(os.listdir(os.path.join(root, "meta_jax")))
    _, mismatch, errors = filecmp.cmpfiles(
        os.path.join(root, "meta_jax"), os.path.join(root, "meta_port"), names,
        shallow=False)
    assert len(names) == N_IMAGES and not mismatch and not errors


@pytest.mark.parametrize("test_scale", [1.0, 0.5])
def test_prepare_test_sample(root, test_scale):
    jds, tds = datasets(root)
    jcfg, tcfg = data_cfgs(test_scale=test_scale)
    for i in (0, 3):
        got = tp.prepare_test_sample(tds, i, tcfg)
        assert_same(got, jp.prepare_test_sample(jds, i, jcfg), f"sample {i}")
    h, w = got["img_shapes"]
    assert (h, w) == (round(375 * test_scale), round(1242 * test_scale))


def test_prepare_train_sample_same_rng(root):
    jds, tds = datasets(root, coord_3d_prefix="obj_crd")
    jcfg, tcfg = data_cfgs()
    flips = set()
    for seed in range(4):
        for i in range(N_IMAGES):
            ref = jp.prepare_train_sample(jds, i, jcfg, np.random.default_rng(seed),
                                          max_pts=32)
            got = tp.prepare_train_sample(tds, i, tcfg, np.random.default_rng(seed),
                                          max_pts=32)
            assert_same(got, ref, f"seed {seed} sample {i}")
            flips.add(bool(ref["flip"]))
    assert flips == {False, True}     # both branches ran
    img = np.random.default_rng(9).uniform(0, 255, (40, 60, 3)).astype(np.float32)
    for seed in range(6):
        assert_same(tp.photometric_distortion(img, np.random.default_rng(seed)),
                    jp.photometric_distortion(img, np.random.default_rng(seed)))


def _transform_sample(seed=0, n_gt=3, h=96, w=160, n_pts=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, w * 0.6, n_gt)
    y = rng.uniform(0, h * 0.6, n_gt)
    boxes = np.stack([x, y, x + rng.uniform(15, 40, n_gt), y + rng.uniform(15, 30, n_gt)],
                     1).astype(np.float32)
    return dict(
        image=rng.normal(size=(h, w, 3)).astype(np.float32),
        gt_boxes=boxes,
        gt_labels=np.arange(n_gt, dtype=np.int32),
        gt_bboxes_3d=rng.normal(size=(n_gt, 7)).astype(np.float32),
        ignore_boxes=np.asarray([[5, 5, 20, 20]], np.float32),
        uv=rng.uniform(0, 90, (n_gt, n_pts, 2)).astype(np.float32),
        oc=rng.normal(size=(n_gt, n_pts, 3)).astype(np.float32),
        pts_valid=np.ones((n_gt, n_pts), bool),
    )


def test_transforms_same_rng():
    for seed in range(5):
        s = _transform_sample(seed)
        for scale in ((0.5, 0.75), (1.5, 1.25)):
            assert_same(tt.resize_sample(s, scale), jt.resize_sample(s, scale))
        box = (10, 8, 120, 80)
        assert_same(tt.crop_sample(s, box, 0.3), jt.crop_sample(s, box, 0.3))
        assert_same(tt.random_crop(s, (64, 96), np.random.default_rng(seed)),
                    jt.random_crop(s, (64, 96), np.random.default_rng(seed)))
        assert_same(tt.min_iou_random_crop(s, np.random.default_rng(seed)),
                    jt.min_iou_random_crop(s, np.random.default_rng(seed)))


def _batches(loader):
    return [dict(b) for b in loader]


@pytest.mark.parametrize("train,indices", [(False, None), (False, [4, 1, 3]),
                                           (True, None)])
def test_loader_order_wrap_and_indices(root, train, indices):
    """Batches of 2 (the tail wraps to the front), the same samples, the
    same order and the same ``_indices``; a second epoch reshuffles."""
    jds, tds = datasets(root, coord_3d_prefix="obj_crd" if train else None)
    jcfg, tcfg = data_cfgs()
    kw = dict(batch_size=2, train=train, seed=5, indices=indices, max_pts=16,
              drop_last=False)
    jload, tload = jl.PrefetchLoader(jds, jcfg, **kw), tl.PrefetchLoader(tds, tcfg, **kw)
    assert len(tload) == len(jload)
    for _ in range(2 if train else 1):
        ref, got = _batches(jload), _batches(tload)
        assert len(got) == len(ref) == len(jload)
        assert_same(got, ref)
    order = np.concatenate([b["_indices"] for b in ref])
    want = np.arange(N_IMAGES) if indices is None else np.asarray(indices)
    assert sorted(set(order.tolist())) == sorted(want.tolist())
    if not train:
        n = len(want)
        assert order[:n].tolist() == want.tolist()
        assert order[n:].tolist() == want[: len(order) - n].tolist()   # wrapped tail
    samples = [tp.prepare_test_sample(tds, i, tcfg) for i in (0, 2)]
    assert_same(tp.collate(samples), jp.collate(samples))


class _Broken(tk.KITTI3DDataset):
    def image_path(self, idx):
        if idx == 3:
            raise ValueError("unreadable sample 3")
        return super().image_path(idx)


def test_loader_worker_error_reaches_the_consumer(root):
    """In the JAX package's loader the exception ends the worker thread
    and the consumer waits for ever; the port's consumer raises it. The
    consumer runs in a thread of its own, joined with a timeout."""
    ds = _Broken(root, "train_list.txt")
    _, tcfg = data_cfgs()
    loader = tl.PrefetchLoader(ds, tcfg, batch_size=2, train=False)
    seen, raised = [], []

    def consume():
        try:
            for batch in loader:
                seen.append(batch["_indices"].tolist())
        except ValueError as e:
            raised.append(str(e))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the consumer is still waiting for a batch"
    assert raised == ["unreadable sample 3"]
    assert seen == [[0, 1]]
