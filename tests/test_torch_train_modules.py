"""The training modules of the port against their JAX counterparts, one by
one: losses, targets (assigner, sampler, RPN targets, dense NOC targets),
the coders' encode halves, the train-mode heads, the score head's targets,
sampling weights and smooth BatchNorm update, the learning-rate schedule,
the group clip and one AdamW update.

The same numpy inputs (from a seed), the same weights (``from_jax_params``)
and the same random draws (computed with the JAX calls on the same keys)
go to both. Tolerance: exact for indices, masks and assignment codes;
1e-6 relative (with a floor of 1e-6 of the output's scale) where the
arithmetic is the same, 1e-5 where a sum over channels or points runs in
another order (heads, segment sums).

The cases that compile JAX programs are in files of at most 3 tests, which
xdist hands out late (ROADMAP's test-time budget):
``test_torch_train_modules_X.py`` for X in adamw, adamw_scaled,
sample_weights, assign, calibration, noc, heads and state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monorun_tpu import losses as jlosses
from monorun_tpu import train as jtrain
from monorun_tpu.config import apply_loss_schedule as japply_schedule
from monorun_tpu.config import get_config
from monorun_tpu.models import score_head as jscore
from monorun_tpu_torch import losses as tlosses
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.config import apply_loss_schedule as tapply_schedule
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models import score_head as tscore

from torch_share import cpu_share  # noqa: F401

CFG = get_config("kitti_multiclass")
TCFG = tget_config("kitti_multiclass")


def _close(got, ref, rtol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def _boxes(rng, n, w=128.0, h=64.0, min_side=2.0, max_side=60.0):
    x1, y1 = rng.uniform(0, w - 4, n), rng.uniform(0, h - 4, n)
    return np.stack([x1, y1, np.minimum(x1 + rng.uniform(min_side, max_side, n), w),
                     np.minimum(y1 + rng.uniform(min_side, max_side, n), h)],
                    1).astype(np.float32)


# ---- losses ------------------------------------------------------------------

def _grads_match(jfn, tfn, arrays, rtol=1e-6):
    """Values and gradients with respect to every array, JAX against port."""
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [_t(a, grad=True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts)
    _close(tv, jv, rtol)
    for a, b in zip(tg, jg):
        _close(a, b, rtol)


@pytest.mark.parametrize("target", ["array", 0, -1])
@pytest.mark.parametrize("reduce", ["mean", "avg_factor", "sum", "weight"])
def test_smooth_l1(target, reduce):
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 2, (12, 4)).astype(np.float32)
    tgt = rng.normal(0, 2, (12, 4)).astype(np.float32)
    w = (rng.uniform(size=(12, 1)) > 0.3).astype(np.float32)
    kw = dict(mean={}, avg_factor=dict(avg_factor=7.0), sum=dict(reduction="sum"),
              weight=dict(weight=w))[reduce]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    if target == "array":
        _grads_match(lambda p, t: jlosses.smooth_l1_loss(p, t, beta=1 / 9, **jkw),
                     lambda p, t: tlosses.smooth_l1_loss(p, t, beta=1 / 9, **tkw), [pred, tgt])
    else:
        _grads_match(lambda p: jlosses.smooth_l1_loss(p, target, **jkw),
                     lambda p: tlosses.smooth_l1_loss(p, target, **tkw), [pred])


def _inv_covs(rng, n):
    a = rng.normal(size=(n, 4, 4)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(4, dtype=np.float32)
    cov[1] = 0.0                                   # singular
    cov[2, 0, 0] = np.nan                          # not finite
    cov[3] = -np.eye(4)                            # not positive-definite
    cov[4] = np.eye(4) * 1e-8                      # nearly singular: logdet < -60
    return cov


def test_calibration_loss_through_the_loss_schedule():
    """loss_calib's weight is 0 until step 100, where apply_loss_schedule
    switches it on; the weighted KL then matches."""
    for step in (0, 99, 100, 250):
        jc, tc = japply_schedule(CFG, step), tapply_schedule(TCFG, step)
        assert tc.pose_head.loss_calib_weight == jc.pose_head.loss_calib_weight
    jc, tc = japply_schedule(CFG, 100), tapply_schedule(TCFG, 100)
    assert tc.pose_head.loss_calib_weight > 0
    rng = np.random.default_rng(3)
    inv = _inv_covs(rng, 8)
    diff = rng.normal(size=(8, 4)).astype(np.float32)
    jl = jlosses.kl_loss_mv(jnp.asarray(diff), 0, jnp.asarray(inv)) * \
        jc.pose_head.loss_calib_weight
    tl = tlosses.kl_loss_mv(_t(diff), 0, _t(inv)) * tc.pose_head.loss_calib_weight
    _close(tl, jl, 1e-5)


# a PnP covariance caught on a padded slot of a training step: finite, and
# so nearly singular that the unrolled Cholesky of it + I overflows
NEAR_SINGULAR = np.array([
    [660987328.0, 133372856.0, 20709664.0, -61281908.0],
    [133372856.0, 27177912.0, 2809807.75, -17088098.0],
    [20709652.0, 2809805.75, 7689557.5, 22369620.0],
    [-61281960.0, -17088106.0, 22369618.0, 89478480.0]], np.float32) - np.eye(4, dtype=np.float32)


# ---- targets -----------------------------------------------------------------

# ---- coders ------------------------------------------------------------------

# ---- train-mode heads --------------------------------------------------------

# the score bands of the kitti_multiclass score head: below strong_neg,
# between strong_neg and the threshold, between the threshold and
# strong_pos, above strong_pos, and padded rows
IOUS = np.array([0.0, 0.05, 0.2, 0.3, 0.45, 0.5, 0.55, 0.6, 0.7, 0.8, 0.95, 1.0], np.float32)


@pytest.mark.parametrize("mode", ["linear_average", "thres", "iou"])
def test_score_targets(mode):
    scfg = dataclasses.replace(CFG.score_head, mode=mode)
    tcfg = dataclasses.replace(TCFG.score_head, mode=mode)
    _close(tscore.score_targets(tcfg, _t(IOUS)), jscore.score_targets(scfg, jnp.asarray(IOUS)))


# ---- optimizer ---------------------------------------------------------------

def check_iou3d_balanced_sample_weights(smooth, mix):
    rng = np.random.default_rng(19)
    reps = dict(balanced=[1] * 12, many_pos=[1] * 6 + [6] * 6, many_neg=[8] * 6 + [1] * 6)[mix]
    ious = np.repeat(IOUS, reps)
    valid = rng.uniform(size=ious.shape) > 0.1
    scfg = dataclasses.replace(CFG.score_head, sampler_smooth_keeprate=smooth)
    tcfg = dataclasses.replace(TCFG.score_head, sampler_smooth_keeprate=smooth)
    key = jax.random.PRNGKey(20)
    ref = jscore.iou3d_balanced_sample_weights(scfg, jnp.asarray(ious), key,
                                               valid=jnp.asarray(valid))
    u = _t(jax.random.uniform(key, ious.shape))
    got = tscore.iou3d_balanced_sample_weights(tcfg, _t(ious), u, valid=_t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("smooth", [False])
@pytest.mark.parametrize("mix", ["balanced", "many_pos", "many_neg"])
def test_iou3d_balanced_sample_weights(smooth, mix):
    """The unsmoothed keep rate; the smoothed one is in
    ``test_torch_train_modules_sample_weights.py``."""
    check_iou3d_balanced_sample_weights(smooth, mix)


@pytest.mark.parametrize("step", [0, 1, 250, 499, 500, 501, 3000, 9999, 12000])
def test_lr_schedule(step):
    ref = jtrain.make_lr_schedule(CFG, 10000)(step)
    got = ttrain.make_lr_schedule(TCFG, 10000)(step)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# a small parameter tree in both packages' names: JAX path -> port name
TREE = {
    "backbone/conv1/kernel": "backbone.conv1.weight",                # frozen
    "backbone/layer1_0/bn1/scale": "backbone.layer1.0.bn1.weight",   # frozen
    "backbone/layer2_0/conv1/kernel": "backbone.layer2.0.conv1.weight",
    "neck/lateral0/bias": "neck.lateral_convs.0.conv.bias",
    "rpn_head/rpn_reg/kernel": "rpn_head.rpn_reg.weight",
    "bbox_head/fc_cls/bias": "roi_head.bbox_head.fc_cls.bias",
}


def _tree(rng, scale=1.0):
    shapes = [(3, 3, 2, 4), (4,), (3, 3, 4, 4), (8,), (1, 1, 8, 12), (4,)]
    return {p: (rng.normal(size=s) * scale).astype(np.float32)
            for p, s in zip(TREE, shapes)}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        *head, last = path.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = jnp.asarray(v)
    return out


def test_grad_and_param_statistics():
    """Gradient norms per top-level module and in total, and every
    parameter's gradient and weight rms and mean, keyed by its own name."""
    rng = np.random.default_rng(23)
    grads, params = _tree(rng, 3.0), _tree(rng)
    ref = jtrain.grad_stats(_nest(grads))
    names = [TREE[p] for p in grads]
    got = ttrain.grad_stats(names, [_t(g) for g in grads.values()])
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
    ref = jtrain.param_grad_stats(_nest(grads), _nest(params))
    got = ttrain.param_grad_stats(names, [_t(g) for g in grads.values()],
                                  [_t(p) for p in params.values()])
    for path, name in TREE.items():
        jname = path.replace("/", ".")
        for prefix in ("grad", "weight"):
            for stat in ("rms", "mean"):
                _close(got[f"{prefix}/{name}/{stat}"], ref[f"{prefix}/{jname}/{stat}"])


@pytest.mark.parametrize("kind", ["train", "scene"])
def test_synthetic_batches_are_the_same(kind):
    """The port's copy of utils/synthetic.py draws the same batch from a seed."""
    from monorun_tpu.utils import synthetic as jsyn
    from monorun_tpu_torch.utils import synthetic as tsyn

    name = f"synthetic_{kind}_batch"
    ref = getattr(jsyn, name)(CFG, 2, (64, 128), num_gt=4, num_pts=16, seed=3)
    got = getattr(tsyn, name)(TCFG, 2, (64, 128), num_gt=4, num_pts=16, seed=3)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def check_adamw_update(paramwise, scale):
    """Two updates of the JAX package's make_optimizer (frozen leaves, the
    non-finite zap, the clip, AdamW at the scheduled rate) against the
    port's, on the same parameters and gradients."""
    rng = np.random.default_rng(22)
    params = _tree(rng)
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, grad_clip_paramwise=paramwise))
    tcfg = dataclasses.replace(TCFG, train=dataclasses.replace(
        TCFG.train, grad_clip_paramwise=paramwise))
    tx = jtrain.make_optimizer(cfg, 1000)
    jp = _nest(params)
    state = tx.init(jp)
    tparams = [torch.nn.Parameter(_t(v)) for v in params.values()]
    opt = ttrain.AdamW(tcfg, zip([TREE[p] for p in params], tparams), 1000)
    for it in range(2):
        grads = _tree(rng, scale)
        if it == 1:
            grads["neck/lateral0/bias"][0] = np.nan     # zapped, not clipped to NaN
        updates, state = tx.update(_nest(grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([_t(g) for g in grads.values()])
        assert int(ttrain.count_nonfinite_leaves([_t(g) for g in grads.values()])) == it
    jflat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for p, tp in zip(params, tparams):
        _close(tp.detach(), jflat[p])
        if p.startswith(("backbone/conv1", "backbone/layer1")):
            np.testing.assert_array_equal(tp.detach().numpy(), params[p])
