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
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monorun_tpu import coders as jcoders
from monorun_tpu import losses as jlosses
from monorun_tpu import train as jtrain
from monorun_tpu.config import apply_loss_schedule as japply_schedule
from monorun_tpu.config import get_config
from monorun_tpu.models import global_head as jglobal
from monorun_tpu.models import noc_head as jnoc
from monorun_tpu.models import score_head as jscore
from monorun_tpu.targets import assigner as jassign
from monorun_tpu.targets import dense_target as jdense
from monorun_tpu.targets import rpn_targets as jrpn
from monorun_tpu.targets import sampler as jsampler
from monorun_tpu_torch import coders as tcoders
from monorun_tpu_torch import losses as tlosses
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.config import apply_loss_schedule as tapply_schedule
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models import global_head as tglobal
from monorun_tpu_torch.models import noc_head as tnoc
from monorun_tpu_torch.models import score_head as tscore
from monorun_tpu_torch.targets import assigner as tassign
from monorun_tpu_torch.targets import dense_target as tdense
from monorun_tpu_torch.targets import rpn_targets as trpn
from monorun_tpu_torch.targets import sampler as tsampler

from test_torch_modules import _load, _randomize

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


def _inv_covs(rng, n):
    a = rng.normal(size=(n, 4, 4)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(4, dtype=np.float32)
    cov[1] = 0.0                                   # singular
    cov[2, 0, 0] = np.nan                          # not finite
    cov[3] = -np.eye(4)                            # not positive-definite
    cov[4] = np.eye(4) * 1e-8                      # nearly singular: logdet < -60
    return cov


def test_kl_loss_mv_guards():
    rng = np.random.default_rng(2)
    n = 8
    inv = _inv_covs(rng, n)
    diff = rng.normal(size=(n, 4)).astype(np.float32)
    w = (rng.uniform(size=(n, 1)) > 0.2).astype(np.float32)
    _grads_match(lambda d, ic: jlosses.kl_loss_mv(d, 0, ic, weight=jnp.asarray(w)),
                 lambda d, ic: tlosses.kl_loss_mv(d, 0, ic, weight=_t(w)), [diff, inv],
                 rtol=1e-5)


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


def test_classification_losses():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 4, (20, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 20)
    w = (rng.uniform(size=20) > 0.3).astype(np.float32)
    _grads_match(
        lambda x: jlosses.softmax_ce_loss(x, jnp.asarray(labels), weight=jnp.asarray(w),
                                          avg_factor=jnp.asarray(w.sum())),
        lambda x: tlosses.softmax_ce_loss(x, _t(labels), weight=_t(w), avg_factor=_t(w.sum())),
        [logits])
    tg = rng.uniform(size=(20, 4)).astype(np.float32)
    _grads_match(lambda x: jlosses.sigmoid_bce_loss(x, jnp.asarray(tg)),
                 lambda x: tlosses.sigmoid_bce_loss(x, _t(tg)), [logits])
    _close(tlosses.weighted_reduce(_t(tg), _t(w[:, None]), avg_factor=_t(0.0)),
           jlosses.weighted_reduce(jnp.asarray(tg), jnp.asarray(w[:, None]),
                                   avg_factor=jnp.asarray(0.0)))


# ---- targets -----------------------------------------------------------------

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


def test_rpn_loss_with_the_jax_noise():
    rng = np.random.default_rng(7)
    B, A = 2, 3
    sizes = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    cls = [rng.normal(size=(B, h, w, A)).astype(np.float32) for h, w in sizes]
    reg = [rng.normal(0, 0.5, (B, h, w, 4 * A)).astype(np.float32) for h, w in sizes]
    gts = np.stack([_boxes(rng, 5, min_side=10.0) for _ in range(B)])
    gt_valid = np.array([[1, 1, 1, 0, 1], [1, 0, 1, 1, 1]], bool)
    ign = np.stack([_boxes(rng, 2, min_side=20.0) for _ in range(B)])
    ign_valid = np.array([[True, False], [False, False]])
    tr = dataclasses.replace(CFG.train, rpn_num_samples=64)
    key = jax.random.PRNGKey(8)
    n = sum(h * w * A for h, w in sizes)

    def jloss(c, r):
        out = jrpn.rpn_loss(key, c, r, *map(jnp.asarray, (gts, gt_valid, ign, ign_valid)),
                            CFG.rpn, tr)
        return out["loss_rpn_cls"] + 10 * out["loss_rpn_bbox"], out

    pairs = [jax.random.split(k) for k in jax.random.split(key, B)]
    noise = tuple(_t(np.stack([np.asarray(jax.random.uniform(p[i], (n,))) for p in pairs]))
                  for i in (0, 1))
    (_, jout), (gc, gr) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])
    tc = [_t(c, grad=True) for c in cls]
    trg = [_t(r, grad=True) for r in reg]
    tout = trpn.rpn_loss(noise, tc, trg, *map(_t, (gts, gt_valid, ign, ign_valid)),
                         TCFG.rpn, dataclasses.replace(TCFG.train, rpn_num_samples=64))
    for k in ("loss_rpn_cls", "loss_rpn_bbox"):
        _close(tout[k], jout[k])
    grads = torch.autograd.grad(tout["loss_rpn_cls"] + 10 * tout["loss_rpn_bbox"], tc + trg)
    for a, b in zip(grads, list(gc) + list(gr)):
        _close(a, b)


def test_dense_noc_targets():
    rng = np.random.default_rng(9)
    G, Q, P, S = 4, 40, 6, 8
    dims = rng.uniform(1, 4, (G, 3)).astype(np.float32)
    oc = rng.uniform(-1, 1, (G, Q, 3)).astype(np.float32) * dims[:, None] / 2
    flip = np.array([True, False, True, False])
    jenc = jdense.encode_noc_points(jnp.asarray(oc), jnp.asarray(dims[:, None]),
                                    jnp.asarray(flip[:, None]), CFG.noc_head.noc_means,
                                    CFG.noc_head.noc_stds)
    tenc = tdense.encode_noc_points(_t(oc), _t(dims[:, None]), _t(flip[:, None]),
                                    TCFG.noc_head.noc_means, TCFG.noc_head.noc_stds)
    _close(tenc, jenc)
    rois = _boxes(rng, P, min_side=10.0)
    rois[5] = rois[4]                              # two RoIs on one GT
    uv = np.stack([rng.uniform(0, 128, (G, Q)), rng.uniform(0, 64, (G, Q))], -1
                  ).astype(np.float32)
    pts_valid = rng.uniform(size=(G, Q)) > 0.3
    pos_valid = np.array([1, 1, 0, 1, 1, 1], bool)
    gt_inds = np.array([0, 1, 2, 3, 1, 1])
    jt, jw = jdense.sparse_noc_targets(*map(jnp.asarray, (rois, pos_valid, gt_inds, uv)),
                                       jenc, jnp.asarray(pts_valid), S)
    tt_, tw = tdense.sparse_noc_targets(*map(_t, (rois, pos_valid, gt_inds, uv)), tenc,
                                        _t(pts_valid), S)
    _close(tt_, jt, 1e-5)
    _close(tw, jw)
    assert float(jw.max()) > 0


# ---- coders ------------------------------------------------------------------

def test_coder_encodes():
    rng = np.random.default_rng(10)
    n = 5
    labels = rng.integers(0, 3, n)
    dims = rng.uniform(0.5, 4, (n, 3)).astype(np.float32)
    _close(tcoders.DimCoder().encode(_t(dims), _t(labels)),
           jcoders.DimCoder().encode(jnp.asarray(dims), jnp.asarray(labels)))
    mask = (rng.uniform(size=(n, 6, 6, 1)) > 0.4).astype(np.float32) * \
        rng.uniform(0.5, 2, (n, 6, 6, 1)).astype(np.float32)
    coords = rng.normal(size=(n, 6, 6, 3)).astype(np.float32) * mask
    flip = np.array([True, False, False, True, True])
    jn = jcoders.NOCCoder().encode(*map(jnp.asarray, (coords, mask, dims, flip)))
    tn = tcoders.NOCCoder().encode(*map(_t, (coords, mask, dims, flip)))
    for a, b in zip(tn, jn):
        _close(a, b)
    err = rng.normal(0, 5, (n, 6, 6, 2)).astype(np.float32)
    dist = rng.uniform(0.01, 40, (n, 1)).astype(np.float32)
    jp, tp = jcoders.ProjErrorCoder(), tcoders.ProjErrorCoder()
    _close(tp.encode(_t(err), _t(dist)), jp.encode(jnp.asarray(err), jnp.asarray(dist)))
    _close(tp.decode(_t(err), _t(dist)), jp.decode(jnp.asarray(err), jnp.asarray(dist)))
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    vec = tcoders.encode_rotation(_t(yaw))
    _close(vec, jcoders.encode_rotation(jnp.asarray(yaw)))
    _close(tcoders.decode_rotation(vec), jcoders.decode_rotation(jnp.asarray(vec.numpy())))
    _close(tcoders.decode_rotation(vec), yaw, 1e-5)


# ---- train-mode heads --------------------------------------------------------

def test_global_head_train_sample_with_the_jax_masks():
    gcfg = dataclasses.replace(CFG.global_head, in_channels=16, fc_out_channels=32)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 7, 7, 16)).astype(np.float32)
    jm = jglobal.GlobalHead(gcfg)
    key = jax.random.PRNGKey(12)
    v = _randomize(jm.init(jax.random.PRNGKey(13), jnp.asarray(x), train=False, rng=key), 11)
    ref = jm.apply(v, jnp.asarray(x), train=True, rng=key)
    r2d, r0, r1 = jax.random.split(key, 3)
    masks = (jax.random.bernoulli(r2d, 1 - gcfg.dropout2d_rate, (6, 16, 1))[..., 0],
             jax.random.bernoulli(r0, 1 - gcfg.dropout_rate, (6, 32)),
             jax.random.bernoulli(r1, 1 - gcfg.dropout_rate, (6, 32)))
    tg = dataclasses.replace(TCFG.global_head, in_channels=16, fc_out_channels=32)
    tm = _load(tglobal.GlobalHead(tg), v, "global_head", "roi_head.global_head.")
    got = tm.forward_train(_t(x), tuple(_t(m) for m in masks))
    assert got.dim_latent_var is None and ref.dim_latent_var is None
    _close(got.dim_latent_pred, ref.dim_latent_pred, 1e-5)
    _close(got.reg_fc_out, ref.reg_fc_out, 1e-5)
    drawn = tglobal.train_dropout_masks(tg, 2000, "cpu", torch.Generator().manual_seed(0))
    assert abs(float(drawn[0].float().mean()) - (1 - tg.dropout2d_rate)) < 0.01


def test_noc_head_dropout2d_with_the_jax_mask():
    ncfg = dataclasses.replace(CFG.noc_head, in_channels=16, conv_out_channels=16,
                               carafe_compressed_channels=8, roi_size=6, dense_size=12,
                               dropout2d_rate=0.5)
    rng = np.random.default_rng(14)
    n = 5
    x = rng.normal(size=(n, 6, 6, 16)).astype(np.float32)
    latent = rng.normal(size=(n, 16)).astype(np.float32)
    labels = np.array([0, 1, 2, 1, 0])
    flip = np.array([False, True, False, True, False])
    jm = jnoc.NOCHead(ncfg)
    args = tuple(map(jnp.asarray, (x, latent, labels, flip)))
    key = jax.random.PRNGKey(15)
    v = _randomize(jm.init(jax.random.PRNGKey(16), *args, train=False), 14)
    ref = jm.apply(v, *args, train=True, rng=key)
    keep = jax.random.bernoulli(key, 0.5, (n, 1, 1, 16)).reshape(n, 16)
    tcfg = dataclasses.replace(TCFG.noc_head, in_channels=16, conv_out_channels=16,
                               carafe_compressed_channels=8, roi_size=6, dense_size=12,
                               dropout2d_rate=0.5)
    tm = _load(tnoc.NOCHead(tcfg), v, "noc_head", "roi_head.noc_head.")
    got = tm(*map(_t, (x, latent, labels, flip)), dropout_keep=_t(keep))
    _close(got.noc_pred, ref.noc_pred, 1e-4)
    _close(got.proj_logstd, ref.proj_logstd, 1e-4)


def test_score_head_train_updates_the_smooth_batchnorm():
    """Masked moments of the valid rows, the EMA update, normalisation with
    the updated statistics; padded rows zeroed; no update from one row."""
    scfg = dataclasses.replace(CFG.score_head, reg_fc_out_channels=32,
                               pose_fc_out_channels=32, fc_out_channels=16)
    rng = np.random.default_rng(17)
    n = 9
    ins = [rng.normal(size=(n, 32)), rng.normal(size=(n, 1)), rng.normal(size=(n, 3)),
           rng.normal(size=(n, 4, 4)), rng.uniform(0.5, 4, (n, 3))]
    ins = [a.astype(np.float32) for a in ins]
    jm = jscore.ScoreHead(scfg)
    v = _randomize(jm.init(jax.random.PRNGKey(18), *map(jnp.asarray, ins)), 17)
    tcfg = dataclasses.replace(TCFG.score_head, reg_fc_out_channels=32,
                               pose_fc_out_channels=32, fc_out_channels=16)
    for valid in (rng.uniform(size=n) > 0.3, np.eye(n, dtype=bool)[2]):
        ref, upd = jm.apply(v, *map(jnp.asarray, ins), train=True,
                            valid=jnp.asarray(valid), mutable=["batch_stats"])
        tm = _load(tscore.ScoreHead(tcfg), v, "score_head", "roi_head.score_head.")
        got = tm(*map(_t, ins), train=True, valid=_t(valid))
        _close(got, ref, 1e-5)
        stats = upd["batch_stats"]["pose_norm"]
        _close(tm.pose_norm.running_mean, stats["mean"], 1e-5)
        _close(tm.pose_norm.running_var, stats["var"], 1e-5)


# the score bands of the kitti_multiclass score head: below strong_neg,
# between strong_neg and the threshold, between the threshold and
# strong_pos, above strong_pos, and padded rows
IOUS = np.array([0.0, 0.05, 0.2, 0.3, 0.45, 0.5, 0.55, 0.6, 0.7, 0.8, 0.95, 1.0], np.float32)


@pytest.mark.parametrize("mode", ["linear_average", "thres", "iou"])
def test_score_targets(mode):
    scfg = dataclasses.replace(CFG.score_head, mode=mode)
    tcfg = dataclasses.replace(TCFG.score_head, mode=mode)
    _close(tscore.score_targets(tcfg, _t(IOUS)), jscore.score_targets(scfg, jnp.asarray(IOUS)))


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("mix", ["balanced", "many_pos", "many_neg"])
def test_iou3d_balanced_sample_weights(smooth, mix):
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


# ---- optimizer ---------------------------------------------------------------

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


def test_group_clip():
    rng = np.random.default_rng(21)
    grads = _tree(rng, 5.0)
    paramwise = (("rpn_head", 2.0), ("neck", 0.0), ("backbone", 1e6))
    ref = jtrain.clip_by_group_norms(3.0, paramwise).update(_nest(grads), None)[0]
    jflat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    names = [TREE[p] for p in grads]
    got = ttrain.clip_by_group_norms(names, [_t(g) for g in grads.values()], 3.0, paramwise)
    for p, g in zip(grads, got):
        _close(g, jflat[p])


@pytest.mark.parametrize("paramwise", [(), (("rpn_head", 0.5),)])
@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_adamw_update_matches_optax(paramwise, scale):
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


def test_create_train_state_on_the_cpu():
    """The training entry point runs on the GPU unless asked for the CPU:
    without a GPU a CUDA request raises."""
    tiny = dataclasses.replace(TCFG, backbone=dataclasses.replace(TCFG.backbone, depth=26))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.create_train_state(tiny, total_steps=10)
    model, state, opt = ttrain.create_train_state(tiny, total_steps=10, device="cpu", seed=1)
    assert state.step == 0 and float(state.loss_ema) == 1.0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    frozen = [n for n, t in zip(opt.names, opt.trainable) if not t]
    assert frozen and all(n.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1."))
                          for n in frozen)
