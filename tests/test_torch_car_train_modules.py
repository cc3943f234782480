"""The LiDAR-supervised single-class preset's training modules, port against
JAX: the class-agnostic NOC head in train mode, its dense targets from the
``obj_crd`` points, and the NOC loss of ``with_lidar_loss``.

``kitti_car_lidar_supv`` trains the class-agnostic NOC head under a
channel dropout of 0.5, on targets that ``sparse_noc_targets`` bins from
the mini-KITTI's LiDAR points (``obj_crd/``, read by
``KITTI3DDataset(classes=("Car",))``), with ``loss_noc`` the smooth L1
of the head's NOC map against them, weighted by the targets' weights and
the positives' validity (``models/detector.py``'s ``with_lidar_loss``
branch). JAX's dropout mask is injected into the port. Tolerances: the
NOC maps to 1e-4 of their scale, as ``tests/test_torch_train_modules_noc.py``;
the targets to 1e-5 and their weights to 1e-6; the loss to 1e-5 and each
parameter's gradient to 1e-4 of its leaf's largest entry, as
``tests/test_torch_train_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_mini_kitti
from monorun_tpu import losses as jlosses
from monorun_tpu.config import get_config
from monorun_tpu.data import kitti as jk
from monorun_tpu.data import pipeline as jp
from monorun_tpu.models import noc_head as jnoc
from monorun_tpu.targets import dense_target as jdense
from monorun_tpu_torch import losses as tlosses
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models import noc_head as tnoc
from monorun_tpu_torch.targets import dense_target as tdense
from monorun_tpu_torch.utils.weights import to_jax_leaves

from test_torch_car_modules import noc_case
from test_torch_modules import _load, _randomize, jitted
from test_torch_train_modules import _close, _t
from torch_share import cpu_share  # noqa: F401

CFG = get_config("kitti_car_lidar_supv")
TCFG = tget_config("kitti_car_lidar_supv")
N_IMAGES = 5
P = 6                 # positive slots per image
DENSE = 12            # the tiny NOC head's dense size


def train_case(num_classes, seed):
    """``noc_case`` at the LiDAR preset's dropout2d rate, with its JAX
    variables, inputs and the mask JAX draws under its key."""
    ncfg, tcfg, ins = noc_case(num_classes, seed)
    rate = CFG.noc_head.dropout2d_rate
    assert rate == TCFG.noc_head.dropout2d_rate == 0.5
    ncfg = dataclasses.replace(ncfg, dropout2d_rate=rate)
    tcfg = dataclasses.replace(tcfg, dropout2d_rate=rate)
    jm = jnoc.NOCHead(ncfg)
    args = tuple(map(jnp.asarray, ins))
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(seed), *args, train=False), seed)
    key = jax.random.PRNGKey(seed + 1)
    n, C = ins[0].shape[0], ins[0].shape[-1]
    keep = np.asarray(jax.random.bernoulli(key, 1 - rate, (n, 1, 1, C)).reshape(n, C))
    tm = _load(tnoc.NOCHead(tcfg), v, "noc_head", "roi_head.noc_head.")
    return jm, v, args, key, tm, ins, keep


def test_noc_head_class_agnostic_dropout2d_with_the_jax_mask():
    """Train mode at dropout2d 0.5, at one class and at 3 classes with mixed
    labels and flipped RoIs."""
    for num_classes, seed in ((1, 31), (3, 32)):
        jm, v, args, key, tm, ins, keep = train_case(num_classes, seed)
        assert 0 < keep.mean() < 1
        ref = jitted(jm.apply, v, *args, train=True, rng=key)
        got = tm(*map(_t, ins), dropout_keep=_t(keep))
        _close(got.noc_pred, ref.noc_pred, 1e-4)
        _close(got.proj_logstd, ref.proj_logstd, 1e-4)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Two collated training samples of the car dataset's LiDAR points (one
    flipped, one not) and P positive RoIs an image on their GTs."""
    root = str(tmp_path_factory.mktemp("mini_kitti_lidar"))
    make_mini_kitti(root, n_images=N_IMAGES, seed=3)
    ds = jk.KITTI3DDataset(root, "train_list.txt", classes=CFG.data.classes,
                           coord_3d_prefix="obj_crd")
    picked = {}
    for seed in range(16):
        for i in range(N_IMAGES):
            s = jp.prepare_train_sample(ds, i, CFG.data, np.random.default_rng(seed),
                                        max_pts=64)
            if s["pts_valid"].any() and bool(s["flip"]) not in picked:
                picked[bool(s["flip"])] = s
        if len(picked) == 2:
            break
    batch = jp.collate([picked[True], picked[False]])
    rng = np.random.default_rng(33)
    gt_inds = np.stack([rng.integers(0, max(int(v.sum()), 1), P) for v in batch["gt_valid"]])
    boxes = np.take_along_axis(batch["gt_boxes"], gt_inds[..., None], 1)
    rois = (boxes + rng.normal(0, 2, boxes.shape)).astype(np.float32)
    pos_valid = np.ones((2, P), bool)
    pos_valid[:, -1] = False
    return batch, rois, pos_valid, gt_inds


def jax_targets(batch, rois, pos_valid, gt_inds, nh, dense):
    """JAX's LiDAR targets as ``_train_forward`` makes them (``jax.vmap``
    over the images): (B*P, S, S, 3), (B*P, S, S, 1)."""
    a = {k: jnp.asarray(batch[k]) for k in ("oc", "gt_bboxes_3d", "flip", "uv", "pts_valid")}
    oc_enc = jdense.encode_noc_points(a["oc"], a["gt_bboxes_3d"][:, :, None, :3],
                                      a["flip"][:, None, None], nh.noc_means, nh.noc_stds)
    tg, wg = jax.vmap(lambda *x: jdense.sparse_noc_targets(*x, dense))(
        jnp.asarray(rois), jnp.asarray(pos_valid), jnp.asarray(gt_inds), a["uv"], oc_enc,
        a["pts_valid"])
    return (np.asarray(tg).reshape(-1, dense, dense, 3),
            np.asarray(wg).reshape(-1, dense, dense, 1))


def port_targets(batch, rois, pos_valid, gt_inds, nh, dense):
    """The port's, as ``MonoRUn.train_forward`` makes them (image by image)."""
    a = {k: _t(batch[k]) for k in ("oc", "gt_bboxes_3d", "flip", "uv", "pts_valid")}
    oc_enc = tdense.encode_noc_points(a["oc"], a["gt_bboxes_3d"][:, :, None, :3],
                                      a["flip"][:, None, None], nh.noc_means, nh.noc_stds)
    tg, wg = zip(*(tdense.sparse_noc_targets(
        _t(rois[b]), _t(pos_valid[b]), _t(gt_inds[b]), a["uv"][b], oc_enc[b],
        a["pts_valid"][b], dense) for b in range(rois.shape[0])))
    return (torch.stack(tg).reshape(-1, dense, dense, 3),
            torch.stack(wg).reshape(-1, dense, dense, 1))


def test_dense_noc_targets_from_the_obj_crd_points(samples):
    """The encoded LiDAR points binned onto each positive's dense grid, at
    the preset's dense size, flipped and not."""
    nh, tnh = CFG.noc_head, TCFG.noc_head
    assert nh.class_agnostic and nh.with_lidar_loss
    jt, jw = jax_targets(*samples, nh, nh.dense_size)
    tt_, tw = port_targets(*samples, tnh, tnh.dense_size)
    _close(tt_, jt, 1e-5)
    _close(tw, jw)
    assert (jw > 0).sum() > 20


def test_noc_loss_with_lidar_loss_and_its_gradients(samples):
    """``loss_noc`` of the class-agnostic head in train mode on those
    targets, and its gradient to every parameter of the head."""
    batch, rois, pos_valid, gt_inds = samples
    jm, v, _, key, tm, ins, _ = train_case(1, 34)
    n = rois.shape[0] * P
    rng = np.random.default_rng(34)
    x = rng.normal(size=(n,) + ins[0].shape[1:]).astype(np.float32)
    latent = rng.normal(size=(n, ins[1].shape[1])).astype(np.float32)
    labels = np.zeros(n, np.int64)
    flip = np.repeat(batch["flip"], P)
    keep = np.asarray(jax.random.bernoulli(key, 0.5, (n, 1, 1, x.shape[-1])).reshape(n, -1))
    weight_valid = pos_valid.reshape(-1)[:, None, None, None].astype(np.float32)
    jt, jw = jax_targets(*samples, jm.cfg, DENSE)
    tt_, tw = port_targets(*samples, tm.cfg, DENSE)

    def jloss(params):
        out = jm.apply({"params": params}, *map(jnp.asarray, (x, latent, labels, flip)),
                       train=True, rng=key)
        return jlosses.smooth_l1_loss(out.noc_pred, jnp.asarray(jt), beta=1.0,
                                      weight=jnp.asarray(jw) * weight_valid)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(v["params"])
    out = tm(*map(_t, (x, latent, labels, flip)), dropout_keep=_t(keep))
    tl = tlosses.smooth_l1_loss(out.noc_pred, tt_, beta=1.0, weight=tw * _t(weight_valid))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(jl) > 0
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in tm.named_parameters()])
    paths = ["noc_head/" + "/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    tg = to_jax_leaves({f"roi_head.noc_head.{k}": g for k, g in zip(names, grads)}, paths)
    jflat = {p: np.asarray(leaf) for p, leaf in zip(paths, jax.tree_util.tree_leaves(jg))}
    assert set(tg) == set(jflat) and len(paths) == len(names)
    for p, ref in jflat.items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(tg[p] - ref).max()) <= 1e-4 * scale, p
