"""The port's modules against their JAX counterparts, one by one.

Every case feeds the same numpy inputs (from a seed) and the same weights
(the JAX module's variables with non-trivial values, carried over by
``from_jax_params``) to both packages and compares in float32. Tolerances:
exact for index and mask outputs; 1e-5 relative (with an absolute floor
of 1e-5 of the output's scale) for float outputs, which differ only by
summation order.

The modules whose JAX side compiles longest are in
``test_torch_modules_{backbone,rpn,heads,nms,rotated}.py``: files of at most 3
tests, which xdist hands out late (ROADMAP's test-time budget).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu import config as jconfig
from monorun_tpu.config import get_config
from monorun_tpu.data import pipeline as jpipe
from monorun_tpu.models import global_head as jglobal
from monorun_tpu.models import score_head as jscore
from monorun_tpu.ops import box_coder as jbox
from monorun_tpu.ops import carafe as jcarafe
from monorun_tpu.ops import nms as jnms
from monorun_tpu_torch import config as tconfig
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.data import pipeline as tpipe
from monorun_tpu_torch.models import global_head as tglobal
from monorun_tpu_torch.models import score_head as tscore
from monorun_tpu_torch.ops import box_coder as tbox
from monorun_tpu_torch.ops import carafe as tcarafe
from monorun_tpu_torch.ops import nms as tnms
from monorun_tpu_torch.utils.weights import from_jax_params

from torch_share import cpu_share  # noqa: F401

CFG = get_config("kitti_multiclass")
TCFG = tget_config("kitti_multiclass")


def _close(got, ref, rtol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(variables, seed=0):
    """Non-trivial values for every leaf the initialisers leave constant
    (BatchNorm statistics, biases, zero-initialised kernels)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        name = getattr(path[-1], "key", "")
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if x.ndim == 1:
            return rng.normal(0, 0.05, x.shape).astype(np.float32)
        if not x.any():
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, jax.tree.map(np.asarray, variables))


def jitted(fn, *args, **kw):
    """``fn(*args, **kw)`` as one ``jax.jit`` program with the keywords closed
    over: one compile, where an eager call compiles and dispatches each op
    (a flax ``init`` runs the whole forward too)."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def _load(module, variables, jax_name, torch_prefix):
    """Load one JAX submodule's variables into the port module."""
    stats = variables.get("batch_stats", {})
    sd = from_jax_params({jax_name: variables["params"]},
                         {jax_name: stats} if stats else {})
    sd = {k[len(torch_prefix):]: v for k, v in sd.items()}
    module.load_state_dict(sd)
    return module.eval()


# ---- config (item 1) -------------------------------------------------------

@pytest.mark.parametrize("name", [
    "kitti_multiclass", "kitti_multiclass_trainval", "kitti_multiclass_lidar_supv",
    "kitti_multiclass_lidar_supv_trainval", "kitti_car", "kitti_car_lidar_supv",
    "kitti_multiclass_fast", "kitti_multiclass_fast_r50", "kitti_multiclass_fast2",
    "kitti_multiclass_fast2_r50", "kitti_multiclass_fast3_r50",
])
def test_config_copy_matches(name):
    """The port's copy of config.py: every preset field by field, and the
    CLI deep-merge on the same overrides."""
    assert dataclasses.asdict(tget_config(name)) == dataclasses.asdict(get_config(name))
    ov = ["test.max_per_img=50", "neck.lazy_lower=False", "data.train_root=x/"]
    assert dataclasses.asdict(tconfig.apply_overrides(tget_config(name), ov)) == \
        dataclasses.asdict(jconfig.apply_overrides(get_config(name), ov))


# ---- coders (item 2) -------------------------------------------------------

# ---- box coder (item 3) ----------------------------------------------------

def test_box_coder_and_anchors():
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 100, (8, 2))
    props = np.concatenate([xy, xy + rng.uniform(2, 50, (8, 2))], 1).astype(np.float32)
    gts = props + rng.normal(0, 3, props.shape).astype(np.float32)
    means, stds = (0.0, 0.1, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)
    _close(tbox.delta_encode(_t(props), _t(gts), means, stds),
           jbox.delta_encode(jnp.asarray(props), jnp.asarray(gts), means, stds))
    deltas = rng.normal(0, 2, props.shape).astype(np.float32)
    for max_shape in (None, (64, 96)):
        _close(tbox.delta_decode(_t(props), _t(deltas), means, stds, max_shape),
               jbox.delta_decode(jnp.asarray(props), jnp.asarray(deltas), means,
                                 stds, max_shape))
    a = CFG.rpn.anchors
    sizes = [(4, 6), (2, 3)]
    for t, j in zip(tbox.multilevel_anchors(sizes, a.strides[:2], a.scales, a.ratios),
                    jbox.multilevel_anchors(sizes, a.strides[:2], a.scales, a.ratios)):
        _close(t, j)


# ---- NMS and rotated IoU (item 4) -----------------------------------------

def _chain(n=40, step=1.2):
    """Boxes along a line, each overlapping its neighbours above 0.7: a
    suppression chain as deep as the box count."""
    x = np.arange(n, dtype=np.float32) * step
    boxes = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1).astype(np.float32)
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    return boxes, scores


def test_multiclass_nms():
    rng = np.random.default_rng(3)
    n, k = 30, 3
    xy = rng.uniform(0, 60, (n, 1, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 1, 2))], -1)
    boxes = (boxes + rng.normal(0, 2, (n, k, 4))).astype(np.float32)
    scores = rng.uniform(0, 1, (n, k)).astype(np.float32)
    scores[scores < 0.3] = jnms.NEG_INF
    ref = jnms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 20)
    got = tnms.multiclass_nms(_t(boxes), _t(scores), 0.5, 20)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


# ---- preprocessing (item 5) ------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_device_preprocess(scale):
    dc = dataclasses.replace(CFG.data, pad_height=48, pad_width=96, test_scale=scale)
    tdc = dataclasses.replace(TCFG.data, pad_height=48, pad_width=96, test_scale=scale)
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (2, 64, 96, 3), np.uint8)
    shapes = np.array([[50.0, 90.0], [64.0, 96.0]], np.float32)
    ji, js = jpipe.device_preprocess(jnp.asarray(raw), jnp.asarray(shapes), dc)
    ti, ts = tpipe.device_preprocess(_t(raw), _t(shapes), tdc)
    _close(ti, ji)
    _close(ts, js)
    cam = np.array([[[700.0, 0, 320], [0, 700.0, 180], [0, 0, 1]]] * 2, np.float32)
    _close(tpipe.scale_intrinsics(_t(cam), scale),
           jpipe.scale_intrinsics(jnp.asarray(cam), scale))


# ---- backbone and neck (item 6) ---------------------------------------------

def _nhwc_feats(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ---- RPN (item 7) ----------------------------------------------------------

# ---- bbox head and detections (item 9) -------------------------------------

def _small_head_cfg(cfg):
    return dataclasses.replace(cfg.bbox_head, in_channels=16, fc_out_channels=32)


# ---- MC global head (item 10) ----------------------------------------------

def jax_mc_masks(gcfg, rng, n, channels, dtype=jnp.float32):
    """The masks GlobalHead draws from ``rng`` (global_head.py:145-161)."""
    r2d, r0, r1 = jax.random.split(rng, 3)
    keep2d, keep = 1.0 - gcfg.dropout2d_rate, 1.0 - gcfg.dropout_rate
    S, F = gcfg.mc_samples, gcfg.fc_out_channels
    m2d = jnp.where(
        jax.random.bernoulli(jglobal._fast_key(r2d, gcfg.mc_fast_rng), keep2d,
                             (n, S, channels)),
        jnp.asarray(1.0 / keep2d, dtype), jnp.zeros((), dtype),
    )
    m0 = jglobal._dropout_mask(jglobal._fast_key(r0, gcfg.mc_fast_rng), keep, (n, S, F), dtype)
    m1 = jglobal._dropout_mask(jglobal._fast_key(r1, gcfg.mc_fast_rng), keep, (n, S, F), dtype)
    return tuple(np.asarray(m) for m in (m2d, m0, m1))


def test_global_head_draws_its_own_masks():
    tg = dataclasses.replace(TCFG.global_head, in_channels=16, fc_out_channels=32)
    gen = torch.Generator().manual_seed(0)
    m2d, m0, m1 = tglobal.mc_dropout_masks(tg, 400, torch.float32, "cpu", gen)
    assert m2d.shape == (400, tg.mc_samples, 16)
    assert m0.shape == m1.shape == (400, tg.mc_samples, 32)
    assert set(m2d.unique().tolist()) == {0.0, 1.0 / 0.8}
    assert abs(float((m0 > 0).float().mean()) - 0.5) < 0.01
    assert abs(float((m2d > 0).float().mean()) - 0.8) < 0.01


# ---- CARAFE and NOC head (item 11) -----------------------------------------

def test_carafe_reassembly():
    rng = np.random.default_rng(11)
    f = rng.normal(size=(3, 6, 5, 8)).astype(np.float32)
    k = rng.uniform(size=(3, 6, 5, 4, 25)).astype(np.float32)
    _close(tcarafe.carafe(_t(f), _t(k), 5, 2), jcarafe.carafe(jnp.asarray(f), jnp.asarray(k), 5, 2))
    _close(tcarafe.carafe(_t(f), _t(k), 5, 2),
           jcarafe.carafe_matmul(jnp.asarray(f), jnp.asarray(k), 5, 2))


# ---- score head (item 14) --------------------------------------------------

def test_score_head():
    scfg = dataclasses.replace(CFG.score_head, reg_fc_out_channels=32,
                               pose_fc_out_channels=32, fc_out_channels=16)
    rng = np.random.default_rng(14)
    n = 7
    ins = (rng.normal(size=(n, 32)), rng.normal(size=(n, 1)), rng.normal(size=(n, 3)),
           rng.normal(size=(n, 4, 4)), rng.uniform(0.5, 4, (n, 3)))
    ins = [a.astype(np.float32) for a in ins]
    jm = jscore.ScoreHead(scfg)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(7), *map(jnp.asarray, ins)), 14)
    ref = jitted(jm.apply, v, *map(jnp.asarray, ins))
    tm = _load(tscore.ScoreHead(dataclasses.replace(
        TCFG.score_head, reg_fc_out_channels=32, pose_fc_out_channels=32,
        fc_out_channels=16)), v, "score_head", "roi_head.score_head.")
    with torch.no_grad():
        got = tm(*map(_t, ins))
    _close(got, ref, rtol=1e-5)
