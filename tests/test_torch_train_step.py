"""The whole training step, port against JAX, at a tiny configuration.

The configuration of ``tests/test_train_step.py`` (ResNet-26, 64x128
images, batch 2, 2 MC samples, 2 LM iterations, the lidar NOC loss on),
JAX variables with non-trivial values carried over by
``from_jax_train_state``, and every random draw of the step computed with the
JAX calls on the JAX step's own split keys and injected as ``TrainDraws``.
The JAX side is computed once per test run under ``jax.jit``
(``jax.value_and_grad`` of ``_train_forward``, then the optimizer's
update; ``jax_step``, through ``tests/torch_share.py:run_shared``), and so
is the port's (``port_step``). The tests are spread over files that xdist
hands out late: this file of 3, whose first test builds both, and files of
at most 2 that read them, which go out after every file of 3
(``test_torch_train_step_X.py`` for X in rpn, cls, heads, pose, score,
totals and branches).

Tolerances: every loss to 1e-5 relative (with a floor of 1e-5 of its
scale); each parameter's gradient to 1e-4 of its leaf's largest entry
(float32 summation order through a ResNet-26 backward, and the gather's
scatter order); the terms downstream of the 2-iteration PnP
(``loss_score``, ``mean_iou``) to 1e-3, as ``test_torch_serve.py``
allows its 3D outputs; the parameters after one step as
``test_parameters_after_one_step_match`` states.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models.detector import _train_forward
from monorun_tpu.train import create_train_state
from monorun_tpu.utils.synthetic import synthetic_train_batch
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn, TrainDraws
from monorun_tpu_torch.utils.weights import (from_jax_params, from_jax_train_state,
                                             to_jax_leaves)

from test_torch_modules import _randomize
from torch_share import cpu_share, pack, run_shared, unpack  # noqa: F401

B, H, W = 2, 64, 128
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_dim",
          "loss_noc", "loss_proj", "loss_calib", "loss_score")
AFTER_PNP = ("loss_score", "mean_iou")
LOSS_CASES = LOSSES + ("mean_iou", "total_loss")   # test_losses_match's cases, by file


def tiny_train_config(get_cfg):
    """``tests/test_train_step.py``'s tiny lidar configuration."""
    cfg = get_cfg("kitti_multiclass_lidar_supv")
    r = dataclasses.replace
    return r(
        cfg, compute_dtype="float32",
        backbone=r(cfg.backbone, depth=26),
        rpn=r(cfg.rpn, nms_pre=32, nms_post=32, train_nms_pre=32),
        train=r(cfg.train, rcnn_num_samples=32, max_pos=8, rpn_num_samples=32),
        test=r(cfg.test, rpn_nms_pre=32, rpn_nms_post=32, max_per_img=4),
        global_head=r(cfg.global_head, mc_samples=2),
        pose_head=r(cfg.pose_head, ransac_hypotheses=2, lm_iters=2),
    )


def jax_train_draws(cfg, key, n_anchors, n_props, n_gt):
    """The random draws of ``_train_forward`` under ``key``, recomputed
    with the JAX calls on its split keys, as tensors. The sampler draws
    over the proposals and GTs, the refined re-sample over the sampled
    RoIs and GTs."""
    tr = cfg.train
    n = B * tr.max_pos
    rng_rpn, rng_assign, rng_gh, rng_noc, rng_pnp, rng_score = jax.random.split(key, 6)

    def sampler_noise(rng, size):
        pairs = [jax.random.split(k) for k in jax.random.split(rng, B)]
        return tuple(np.stack([np.asarray(jax.random.uniform(p[i], (size,))) for p in pairs])
                     for i in (0, 1))

    r2d, r0, r1 = jax.random.split(rng_gh, 3)
    gh, nh = cfg.global_head, cfg.noc_head
    C, F = cfg.neck.out_channels, gh.fc_out_channels
    masks = (jax.random.bernoulli(r2d, 1 - gh.dropout2d_rate, (n, C, 1))[..., 0],
             jax.random.bernoulli(r0, 1 - gh.dropout_rate, (n, F)),
             jax.random.bernoulli(r1, 1 - gh.dropout_rate, (n, F)))
    noc = jax.random.bernoulli(rng_noc, 1 - nh.dropout2d_rate, (n, 1, 1, C)).reshape(n, C)
    keys = jax.random.uniform(rng_pnp, (n, cfg.pose_head.ransac_hypotheses,
                                        nh.dense_size ** 2))
    refined = sampler_noise(jax.random.fold_in(rng_assign, 1), tr.rcnn_num_samples + n_gt)

    def t(x):
        return torch.from_numpy(np.array(x))

    return TrainDraws(
        rpn_noise=tuple(map(t, sampler_noise(rng_rpn, n_anchors))),
        rcnn_noise=tuple(map(t, sampler_noise(rng_assign, n_props + n_gt))),
        rcnn_noise_refined=tuple(map(t, refined)),
        global_masks=tuple(map(t, masks)), noc_mask=t(noc), ransac_keys=t(keys),
        score_uniform=t(jax.random.uniform(rng_score, (n,))),
    )


def proposal_count(cfg, feat_sizes, n_anchor_types):
    """get_proposals' output count: per-level top nms_pre, NMS down to
    nms_post, then the global top nms_post."""
    per_level = [min(cfg.rpn.nms_post, min(cfg.rpn.train_nms_pre, h * w * n_anchor_types))
                 for h, w in feat_sizes]
    return min(cfg.rpn.nms_post, sum(per_level))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def draw_counts(tcfg, images):
    """(anchors, proposals): the counts the step's sampler draws are made
    for, from the shapes of the port's RPN outputs on ``images``."""
    model = MonoRUn(tcfg)
    with torch.no_grad():
        cls, _ = model.rpn_head(model.extract_feats(images)[tcfg.rpn.starting_level:])
    sizes = [(c.shape[1], c.shape[2]) for c in cls]
    return sum(c[0].numel() for c in cls), proposal_count(tcfg, sizes, cls[0].shape[-1])


def draw_arrays(draws):
    """``TrainDraws`` -> {field: array or tuple of arrays}, its fields set."""
    return {k: tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy()
            for k, v in draws._asdict().items() if v is not None}


def train_draws_of(arrays):
    """``draw_arrays``' inverse."""
    return TrainDraws(**{k: tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
                         else torch.from_numpy(v) for k, v in arrays.items()})


JAX_STEP = (f"tiny_train_config(kitti_multiclass_lidar_supv), float32, B {B}, {H}x{W}, "
            "synthetic_train_batch(num_gt=6, num_pts=32), create_train_state(PRNGKey(0), "
            "total_steps=100), _randomize(seed 0), step key PRNGKey(1)")


def jax_step():
    """The JAX side of the step, once per test run (``run_shared``): the
    randomized variables, the batch, the draws of the step key, and JAX's
    losses, ``loss_ema``, score statistics, gradients, updates and
    parameters after the optimizer's update, as arrays."""
    def compute():
        cfg = tiny_train_config(get_config)
        model, state, tx = create_train_state(cfg, jax.random.PRNGKey(0), total_steps=100,
                                              image_shape=(H, W))
        variables = _randomize({"params": state.params, "batch_stats": state.batch_stats})
        state = state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                              opt_state=tx.init(variables["params"]))
        batch_np = synthetic_train_batch(cfg, B, (H, W), num_gt=6, num_pts=32)
        batch = jax.tree.map(jnp.asarray, batch_np)
        key = jax.random.PRNGKey(1)

        def loss_fn(params):
            (total, (metrics, new_ema)), updates = model.apply(
                {"params": params, "batch_stats": state.batch_stats}, batch, key, state.step,
                state.loss_ema, method=_train_forward, mutable=["batch_stats"])
            return total, (metrics, new_ema, updates["batch_stats"])

        (total, (jmetrics, jema, jstats)), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(state.params)
        updates, _ = jax.jit(tx.update)(jgrads, state.opt_state, state.params)
        jparams = optax.apply_updates(state.params, updates)
        counts = draw_counts(tiny_train_config(tget_config),
                             torch.from_numpy(np.array(batch_np["images"])))
        draws = jax_train_draws(cfg, key, *counts, batch_np["gt_boxes"].shape[1])
        return dict(
            variables=jax.tree.map(np.asarray, variables), batch=batch_np,
            draws=draw_arrays(draws), loss_ema=np.asarray(state.loss_ema),
            step=np.asarray(state.step), ema=np.asarray(jema),
            metrics={k: np.asarray(v) for k, v in dict(jmetrics, total_loss=total).items()},
            grads=_flat(jgrads), params=_flat(jparams), updates=_flat(updates),
            stats=_flat(jstats))

    return run_shared(f"test_torch_train_step.jax_step: {JAX_STEP}", compute)


def port_step(ref):
    """The port's side on ``jax_step``'s inputs, once per test run
    (``run_shared``, through ``pack``): its losses, ``loss_ema``, gradients
    (as JAX leaves, with ``rpn_reg``'s share through the RoI path), the
    optimizer's updates, the score statistics, and one ``train_step``'s
    state, metrics and parameters from the same start."""
    def compute():
        tcfg = tiny_train_config(tget_config)
        v = ref["variables"]
        sd, ema0, step0 = from_jax_train_state(SimpleNamespace(
            params=v["params"], batch_stats=v["batch_stats"], loss_ema=ref["loss_ema"],
            step=ref["step"]))
        assert step0 == 0
        tmodel = MonoRUn(tcfg)
        tmodel.load_state_dict(sd)
        tbatch = {k: torch.from_numpy(np.array(a)) for k, a in ref["batch"].items()}
        draws = train_draws_of(ref["draws"])
        paths = list(ref["grads"])

        loss_ema = torch.tensor(ema0)
        ttotal, (tmetrics, tema) = tmodel.train_forward(tbatch, loss_ema, draws)
        names = [n for n, _ in tmodel.named_parameters()]
        tgrads = torch.autograd.grad(ttotal, [p for _, p in tmodel.named_parameters()],
                                     retain_graph=True)
        # rpn_reg's gradient through the RPN losses alone; the rest comes by
        # the proposals (the RoI path)
        rpn_reg = tmodel.rpn_head.rpn_reg.weight
        rpn_only = torch.autograd.grad(tmetrics["loss_rpn_cls"] + tmetrics["loss_rpn_bbox"],
                                       rpn_reg)[0]
        roi_path = to_jax_leaves({"rpn_head.rpn_reg.weight": tgrads[names.index(
            "rpn_head.rpn_reg.weight")] - rpn_only}, ["rpn_head/rpn_reg/kernel"])
        tmetrics = {k: v.detach() for k, v in tmetrics.items()}
        tmetrics["total_loss"] = ttotal.detach()

        tupdates = to_jax_leaves(dict(zip(names, ttrain.make_optimizer(tcfg, tmodel, 100)
                                          .update(tgrads))), paths)

        # one train step from the same start
        tmodel.load_state_dict(sd)
        opt = ttrain.make_optimizer(tcfg, tmodel, 100)
        new_state, step_metrics = ttrain.train_step(
            tmodel, opt, ttrain.TrainState(0, loss_ema), tbatch, draws)
        return dict(
            tmetrics=tmetrics, tema=tema.detach(),
            tgrads=to_jax_leaves(dict(zip(names, tgrads)), paths), tupdates=tupdates,
            tparams=to_jax_leaves(dict(tmodel.named_parameters()), paths),
            tstats=to_jax_leaves(dict(tmodel.named_buffers()), list(ref["stats"])),
            new_step=new_state.step, step_metrics=step_metrics,
            roi_path=roi_path["rpn_head/rpn_reg/kernel"],
            lr=float(ttrain.make_lr_schedule(tcfg, 100)(0)))

    return unpack(run_shared(f"test_torch_train_step.port_step: on {JAX_STEP}",
                             lambda: pack(compute())))


@pytest.fixture(scope="module")
def both():
    """JAX's step and the port's on the same inputs (``jax_step``,
    ``port_step``), and the port's weights, batch and draws."""
    ref = jax_step()
    v = ref["variables"]
    return dict(
        port_step(ref), ref=ref, jmetrics=ref["metrics"], jema=ref["ema"],
        jgrads=ref["grads"], jparams=ref["params"], jupdates=ref["updates"],
        jstats=ref["stats"], sd=from_jax_params(v["params"], v["batch_stats"]),
        tbatch={k: torch.from_numpy(np.array(a)) for k, a in ref["batch"].items()},
        draws=train_draws_of(ref["draws"]))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def check_loss(both, name):
    """``test_losses_match``: the port's ``name`` against JAX's."""
    got = float(both["tmetrics"][name])
    ref = float(both["jmetrics"][name])
    assert np.isfinite(got)
    rtol = 1e-3 if name in AFTER_PNP else 1e-5
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(abs(ref), 1e-5))


def test_every_gradient_matches(both):
    jg, tg = both["jgrads"], both["tgrads"]
    assert set(jg) == set(tg)
    worst = {p: _rel(tg[p], jg[p]) for p in jg}
    bad = {p: e for p, e in worst.items() if not e <= 1e-4}
    assert not bad, bad
    # the leaves without gradient are the same: the score head (no RoI
    # passes pose_ok at this configuration and seed, so loss_score is 0),
    # the calibration scales (loss_calib's weight is 0 before step 100) and
    # the neck level no align or RPN level reads
    zero_j = {p for p in jg if not np.abs(jg[p]).any()}
    zero_t = {p for p in tg if not np.abs(tg[p]).any()}
    assert zero_j == zero_t
    assert {p.split("/")[0] for p in zero_j} <= {"score_head", "cov_calib_logscale", "neck"}


def test_rpn_regression_gets_the_roi_path_gradient(both):
    """The RoI-head losses reach rpn_reg through the proposals (the
    regression targets, the RoI grid and the align's RoI gradient), as in
    the JAX package: a share of its gradient that the RPN losses do not
    give, of the size of the whole (the total matches JAX's above)."""
    roi = both["roi_path"]
    total = both["tgrads"]["rpn_head/rpn_reg/kernel"]
    share = np.linalg.norm(roi) / np.linalg.norm(total)
    assert 0.01 < share < 100


def test_parameters_after_one_step_match(both):
    """The optimizer's updates to 1e-4 of lr where the gradient stands above
    1e-3 of its leaf's scale: elsewhere Adam's first step, g / (|g| + eps),
    turns the summation-order noise of near-zero gradients into up to +-lr.
    So the parameters after the step are within 2 lr (and their rounding)
    of JAX's everywhere."""
    jp, tp, jg = both["jparams"], both["tparams"], both["jgrads"]
    ju, tu = both["jupdates"], both["tupdates"]
    lr = both["lr"]
    for p in jp:
        big = np.abs(jg[p]) > 1e-3 * max(np.abs(jg[p]).max(), 1e-30)
        np.testing.assert_allclose(tu[p][big], ju[p][big], rtol=0, atol=1e-4 * lr,
                                   err_msg=p)
        atol = 2 * lr + 2 * np.spacing(np.abs(jp[p]).max())
        np.testing.assert_allclose(tp[p], jp[p], rtol=0, atol=atol, err_msg=p)
    m = both["step_metrics"]
    assert both["new_step"] == 1 and int(m["nonfinite_grad_leaves"]) == 0
    np.testing.assert_allclose(float(m["total_loss"]), float(both["jmetrics"]["total_loss"]),
                               rtol=1e-5)
