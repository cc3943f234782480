"""The single-class preset's modules, port against JAX, one by one.

``kitti_car`` (``config.py:_car_variant``) sets one class: the RPN anchors
at ratios 0.4/0.7/1.0, a bbox head of 2 logits, a global head and
``DimCoder`` of one class, and a class-agnostic NOC head. Each case feeds
the same numpy inputs (from a seed) and the same weights (the JAX module's
variables with non-trivial values, carried over by ``from_jax_params``)
to both packages at tiny widths and compares in float32, at
``tests/test_torch_modules.py``'s tolerances: the anchors to 1e-6, index
and mask outputs exactly, float outputs to 1e-5 of their scale, the head
outputs to 1e-4 and the NOC maps to 1e-4, as
``tests/test_torch_modules_heads.py``. The NOC head's class-agnostic
branch is also held at 3 classes with mixed labels and flipped RoIs,
where choosing a class block would show. Last, the KITTI dataset with
``classes=("Car",)`` on one mini-KITTI through both packages.

Five tests, so that xdist hands this file out after
``tests/test_train_step.py`` (ROADMAP's test-time budget).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_mini_kitti
from monorun_tpu import coders as jcoders
from monorun_tpu.config import get_config
from monorun_tpu.data import kitti as jk
from monorun_tpu.data import pipeline as jp
from monorun_tpu.models import bbox_head as jbbox
from monorun_tpu.models import global_head as jglobal
from monorun_tpu.models import noc_head as jnoc
from monorun_tpu.models import rpn as jrpn
from monorun_tpu.ops import box_coder as jbox
from monorun_tpu_torch import coders as tcoders
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.data import kitti as tk
from monorun_tpu_torch.data import pipeline as tp
from monorun_tpu_torch.models import bbox_head as tbbox
from monorun_tpu_torch.models import global_head as tglobal
from monorun_tpu_torch.models import noc_head as tnoc
from monorun_tpu_torch.models import rpn as trpn
from monorun_tpu_torch.ops import box_coder as tbox

from test_torch_data import assert_same, fake_results
from test_torch_modules import (
    _close, _load, _nhwc_feats, _randomize, _small_head_cfg, _t, jax_mc_masks, jitted,
)
from torch_share import cpu_share  # noqa: F401

CFG = get_config("kitti_car")
TCFG = tget_config("kitti_car")
N_IMAGES = 5


def test_anchors_rpn_head_and_proposals():
    """The anchors at the car ratios (ratio-major over scales, as JAX) to
    1e-6, then the RPN head on 3 anchors a cell and its proposals on them."""
    a = CFG.rpn.anchors
    assert a.ratios == TCFG.rpn.anchors.ratios == (0.4, 0.7, 1.0)
    for stride in a.strides:
        np.testing.assert_allclose(tbox.base_anchors(stride, a.scales, a.ratios).numpy(),
                                   np.asarray(jbox.base_anchors(stride, a.scales, a.ratios)),
                                   rtol=0, atol=1e-6)
    sizes = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    for t, j in zip(tbox.multilevel_anchors(sizes, a.strides, a.scales, a.ratios),
                    jbox.multilevel_anchors(sizes, a.strides, a.scales, a.ratios)):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(np.asarray(j)).max())))

    feats = _nhwc_feats(21, [(2,) + s + (16,) for s in sizes])
    n_anchors = len(a.scales) * len(a.ratios)
    jm = jrpn.RPNHead(feat_channels=16, num_anchors=n_anchors)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(22), [jnp.asarray(f) for f in feats]),
                   21)
    jc, jr = jitted(jm.apply, v, [jnp.asarray(f) for f in feats])
    tm = _load(trpn.RPNHead(16, 16, n_anchors), v, "rpn_head", "rpn_head.")
    with torch.no_grad():
        tc, tr = tm([_t(f) for f in feats])
    for got, ref in zip(tc + tr, jc + jr):
        _close(got, ref, rtol=1e-4)
    shapes = np.array([[60.0, 120.0], [64.0, 128.0]], np.float32)
    rcfg = dataclasses.replace(CFG.rpn, nms_thr=0.7)
    ref = jitted(lambda c, r, s: jrpn.get_proposals(c, r, rcfg, (64, 128), 40, 50,
                                                    valid_shapes=s), jc, jr, jnp.asarray(shapes))
    got = trpn.get_proposals([_t(c) for c in jc], [_t(r) for r in jr],
                             dataclasses.replace(TCFG.rpn, nms_thr=0.7), (64, 128), 40, 50,
                             valid_shapes=_t(shapes))
    _close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.asarray(ref[1]).all(1).any()


def test_bbox_head_and_det_bboxes_at_one_class():
    """Two logits (car, background) and one class's deltas; the detections
    of one class (the serving path's label clamp runs in
    ``tests/test_torch_car_serve.py``'s whole forward)."""
    x = _nhwc_feats(23, [(12, 7, 7, 16)])[0]
    jm = jbbox.BBoxHead(_small_head_cfg(CFG))
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(24), jnp.asarray(x)), 23)
    jc, jd = jitted(jm.apply, v, jnp.asarray(x))
    assert jc.shape == (12, 2) and jd.shape == (12, 4)
    tm = _load(tbbox.BBoxHead(_small_head_cfg(TCFG)), v, "bbox_head", "roi_head.bbox_head.")
    with torch.no_grad():
        tc, td = tm(_t(x))
    _close(tc, jc, rtol=1e-4)
    _close(td, jd, rtol=1e-4)

    rng = np.random.default_rng(23)
    xy = rng.uniform(0, 80, (12, 2))
    rois = np.concatenate([xy, xy + rng.uniform(5, 40, (12, 2))], 1).astype(np.float32)
    valid = np.ones(12, bool)
    valid[-2:] = False
    logits = np.asarray(jc) * 3.0
    deltas = np.asarray(jd)
    ref = jbbox.get_det_bboxes(jnp.asarray(rois), jnp.asarray(logits), jnp.asarray(deltas),
                               jnp.asarray(valid), (64, 128), CFG.bbox_head, 0.05, 0.5, 8)
    got = tbbox.get_det_bboxes(_t(rois), _t(logits), _t(deltas), _t(valid), (64, 128),
                               TCFG.bbox_head, 0.05, 0.5, 8)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    labels, det_valid = np.asarray(ref[2]), np.asarray(ref[3])
    assert det_valid.sum() >= 2 and (labels[det_valid] == 0).all()


def test_global_head_slice_pred_and_dim_coder_at_one_class():
    """One class's (3 + latent) block from injected MC masks, its slice
    under label 0, and the dims through ``DimCoder`` of the car's one
    mean and std, both ways."""
    r = dataclasses.replace
    gcfg = r(CFG.global_head, in_channels=16, fc_out_channels=32, mc_samples=5)
    tg = r(TCFG.global_head, in_channels=16, fc_out_channels=32, mc_samples=5)
    assert gcfg.num_classes == 1 and len(gcfg.dim_means) == 1
    x = _nhwc_feats(25, [(6, 7, 7, 16)])[0]
    jm = jglobal.GlobalHead(gcfg)
    key = jax.random.PRNGKey(26)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(27), jnp.asarray(x), train=False,
                          rng=key), 25)
    ref = jitted(jm.apply, v, jnp.asarray(x), train=False, rng=key)
    assert ref.dim_latent_pred.shape == (6, 3 + gcfg.latent_channels)
    masks = jax_mc_masks(gcfg, key, 6, 16)
    tm = _load(tglobal.GlobalHead(tg), v, "global_head", "roi_head.global_head.")
    with torch.no_grad():
        got = tm(_t(x), masks=tuple(_t(m) for m in masks))
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-5)

    labels = np.zeros(6, np.int64)
    jsl = jglobal.slice_pred(gcfg, ref.dim_latent_pred, ref.dim_latent_var,
                             jnp.asarray(labels))
    tsl = tglobal.slice_pred(tg, got.dim_latent_pred, got.dim_latent_var, _t(labels))
    for a, b in zip(tsl, jsl):
        _close(a, b)
    jdc = jcoders.DimCoder(gcfg.dim_means, gcfg.dim_stds)
    tdc = tcoders.DimCoder(tg.dim_means, tg.dim_stds)
    jdims = jdc.decode(jsl[0], jsl[1], jnp.asarray(labels))
    tdims = tdc.decode(tsl[0], tsl[1], _t(labels))
    for a, b in zip(tdims, jdims):
        _close(a, b)
    dims = np.random.default_rng(25).uniform(1.2, 4.5, (6, 3)).astype(np.float32)
    _close(tdc.encode(_t(dims), _t(labels)), jdc.encode(jnp.asarray(dims), jnp.asarray(labels)))


def noc_case(num_classes, seed):
    """(JAX head config, the port's, inputs): a class-agnostic NOC head of
    ``num_classes`` at tiny widths; labels mixed over the classes, RoIs
    flipped and not."""
    r = dataclasses.replace
    kw = dict(in_channels=16, conv_out_channels=16, carafe_compressed_channels=8,
              roi_size=6, dense_size=12, num_classes=num_classes, class_agnostic=True)
    rng = np.random.default_rng(seed)
    n = 6
    x = rng.normal(size=(n, 6, 6, 16)).astype(np.float32)
    latent = rng.normal(size=(n, 16)).astype(np.float32)
    labels = np.arange(n) % num_classes
    flip = np.array([False, True, False, True, True, False])
    return r(CFG.noc_head, **kw), r(TCFG.noc_head, **kw), (x, latent, labels, flip)


def test_noc_head_class_agnostic_serving():
    """The class-agnostic NOC head in serving mode, at the car's one class
    and at 3 classes with mixed labels and flipped RoIs: one output block
    a flip bank, whatever the label."""
    for num_classes, seed in ((1, 28), (3, 29)):
        ncfg, tcfg, ins = noc_case(num_classes, seed)
        jm = jnoc.NOCHead(ncfg)
        args = tuple(map(jnp.asarray, ins))
        v = _randomize(jitted(jm.init, jax.random.PRNGKey(seed), *args, train=False), seed)
        ref = jitted(jm.apply, v, *args, train=False)
        tm = _load(tnoc.NOCHead(tcfg), v, "noc_head", "roi_head.noc_head.")
        assert tm.conv_final.weight.shape[0] == 2 * (3 + 2)      # two banks, one class
        with torch.no_grad():
            got = tm(*map(_t, ins))
        _close(got.noc_pred, ref.noc_pred, rtol=1e-4)
        _close(got.proj_logstd, ref.proj_logstd, rtol=1e-4)
        if num_classes == 3:
            # the label does not choose: relabelled RoIs give the same maps
            with torch.no_grad():
                again = tm(_t(ins[0]), _t(ins[1]), _t((ins[2] + 1) % 3), _t(ins[3]))
            torch.testing.assert_close(again.noc_pred, got.noc_pred, rtol=0, atol=0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_kitti_car"))
    make_mini_kitti(root, n_images=N_IMAGES, seed=3)
    return root


def test_kitti_dataset_of_cars(root):
    """``KITTI3DDataset(classes=("Car",))``, as ``apis/train.py`` and
    ``tools/test.py`` build it from ``kitti_car``: annotations (the other
    classes filtered out), LiDAR points, result formatting, the GT
    annotations and the training sample on one rng, equal exactly."""
    classes = CFG.data.classes
    assert classes == TCFG.data.classes == ("Car",)
    jds = jk.KITTI3DDataset(root, "train_list.txt", classes=classes, coord_3d_prefix="obj_crd")
    tds = tk.KITTI3DDataset(root, "train_list.txt", classes=classes, coord_3d_prefix="obj_crd")
    n_cars = 0
    for i in range(N_IMAGES):
        ann = jds.get_ann(i)
        assert_same(tds.get_ann(i), ann, f"ann {i}")
        assert_same(tds.get_sparse_coords(i, ann["object_ids"]),
                    jds.get_sparse_coords(i, ann["object_ids"]), f"coords {i}")
        assert (ann["labels"] == 0).all()
        n_cars += len(ann["labels"])
    assert n_cars > 0
    results = fake_results(N_IMAGES, seed=4, with_none=(1,))
    for res in results:
        if res is not None:
            res["labels"] = np.zeros_like(res["labels"])
    assert_same(tds.format_results(results), jds.format_results(results))
    assert_same(tds.format_gt_annos(), jds.format_gt_annos())
    for seed in range(2):
        for i in range(N_IMAGES):
            assert_same(tp.prepare_train_sample(tds, i, TCFG.data, np.random.default_rng(seed),
                                                max_pts=32),
                        jp.prepare_train_sample(jds, i, CFG.data, np.random.default_rng(seed),
                                                max_pts=32), f"seed {seed} sample {i}")
