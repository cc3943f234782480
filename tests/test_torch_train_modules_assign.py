"""``tests/test_torch_train_modules.py``'s assigner and sampler, and the robust
KL loss, in a file of at most 3 tests (xdist hands it out late); that file
states the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monorun_tpu import losses as jlosses
from monorun_tpu.targets import assigner as jassign
from monorun_tpu.targets import sampler as jsampler
from monorun_tpu_torch import losses as tlosses
from monorun_tpu_torch.targets import assigner as tassign
from monorun_tpu_torch.targets import sampler as tsampler

from test_torch_train_modules import CFG, _boxes, _close, _grads_match, _t
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("case", ["rpn", "rcnn"])
def test_assign_and_sample(case):
    """Max-IoU assignment (low-quality matches, ignore regions, padded GTs
    and candidates) and the sampler on the JAX noise of the same keys."""
    rng = np.random.default_rng(5)
    n, g = 300, 6
    gts = _boxes(rng, g, min_side=10.0)
    cand = np.concatenate([_boxes(rng, n - g), gts + rng.normal(0, 2, gts.shape)
                           .astype(np.float32)])
    cand_valid = rng.uniform(size=n) > 0.05
    gt_valid = np.array([1, 1, 1, 1, 0, 1], bool)
    gt_labels = rng.integers(0, 3, g)
    ign = np.concatenate([_boxes(rng, 1, min_side=20.0), np.zeros((1, 4), np.float32)])
    ign_valid = np.array([True, False])
    tr = CFG.train
    if case == "rpn":
        acfg = dict(pos_iou_thr=tr.rpn_pos_iou_thr, neg_iou_thr=tr.rpn_neg_iou_thr,
                    min_pos_iou=tr.rpn_min_pos_iou, ignore_iof_thr=tr.rpn_ignore_iof_thr)
        num, frac, max_pos = 64, 0.5, 32
    else:
        acfg = dict(pos_iou_thr=tr.rcnn_pos_iou_thr, neg_iou_thr=tr.rcnn_neg_iou_thr,
                    min_pos_iou=tr.rcnn_min_pos_iou, ignore_iof_thr=tr.rcnn_ignore_iof_thr)
        num, frac, max_pos = 32, 0.25, 8
    jres = jassign.assign_max_iou(
        *map(jnp.asarray, (cand, cand_valid, gts, gt_valid, gt_labels)),
        jassign.AssignCfg(**acfg), ignore_boxes=jnp.asarray(ign),
        ignore_valid=jnp.asarray(ign_valid))
    tres = tassign.assign_max_iou(
        *map(_t, (cand, cand_valid, gts, gt_valid, gt_labels)), tassign.AssignCfg(**acfg),
        ignore_boxes=_t(ign), ignore_valid=_t(ign_valid))
    np.testing.assert_array_equal(tres.assigned_gt.numpy(), np.asarray(jres.assigned_gt))
    np.testing.assert_array_equal(tres.labels.numpy(), np.asarray(jres.labels))
    _close(tres.max_iou, jres.max_iou)
    codes = set(np.asarray(jres.assigned_gt).tolist())
    assert {-2, -1} <= codes and max(codes) >= 0

    key = jax.random.PRNGKey(6)
    jsamp = jsampler.sample_rois(key, jnp.asarray(cand), jres.assigned_gt, jres.labels, num,
                                 frac, max_pos=max_pos)
    r_pos, r_neg = jax.random.split(key)
    noise = (_t(jax.random.uniform(r_pos, (n,))), _t(jax.random.uniform(r_neg, (n,))))
    tsamp = tsampler.sample_rois(noise, _t(cand), tres.assigned_gt, tres.labels, num, frac,
                                 max_pos=max_pos)
    for a, b in zip(tsamp, jsamp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the eligible ones fill the slots; a short side's ineligible tail ties
    # at -1 and takes the lowest indices, as lax.top_k does
    for valid, eligible, k in ((tsamp.pos_valid, tres.assigned_gt >= 0, max_pos),
                               (tsamp.neg_valid, tres.assigned_gt == -1, num - max_pos)):
        assert int(valid.sum()) == min(k, int(eligible.sum()))
    assert not bool(tsamp.pos_valid.all()) or case == "rcnn"


def test_robust_kl_loss_and_its_ema():
    """The EMA of the mean inverse std moves by the batch term without
    gradient, and the loss is divided by the new EMA."""
    rng = np.random.default_rng(1)
    pred = rng.normal(0, 3, (6, 5, 5, 2)).astype(np.float32)
    logstd = rng.normal(0, 1, (6, 5, 5, 2)).astype(np.float32)
    logstd[0, 0, 0, 0] = -20.0          # the inverse std clips at 1 / eps
    w = np.broadcast_to((rng.uniform(size=(6, 1, 1, 1)) > 0.3), pred.shape).astype(np.float32)
    ema = np.float32(1.3)
    jl, jema = jlosses.robust_kl_loss(jnp.asarray(pred), 0, jnp.asarray(logstd),
                                      jnp.asarray(ema), weight=jnp.asarray(w), momentum=0.1)
    tl, tema = tlosses.robust_kl_loss(_t(pred), 0, _t(logstd), _t(ema), weight=_t(w),
                                      momentum=0.1)
    _close(tl, jl)
    _close(tema, jema)
    _grads_match(
        lambda p, s: jlosses.robust_kl_loss(p, 0, s, jnp.asarray(ema), weight=jnp.asarray(w))[0],
        lambda p, s: tlosses.robust_kl_loss(p, 0, s, _t(ema), weight=_t(w))[0],
        [pred, logstd])
