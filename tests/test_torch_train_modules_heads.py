"""``tests/test_torch_train_modules.py``'s classification losses, RPN loss and
the global head's training sample, in a file of at most 3 tests (xdist hands it
out late); that file states the tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monorun_tpu import losses as jlosses
from monorun_tpu.models import global_head as jglobal
from monorun_tpu.targets import rpn_targets as jrpn
from monorun_tpu_torch import losses as tlosses
from monorun_tpu_torch.models import global_head as tglobal
from monorun_tpu_torch.targets import rpn_targets as trpn

from test_torch_modules import _load, _randomize, jitted
from test_torch_train_modules import CFG, TCFG, _boxes, _close, _grads_match, _t
from torch_share import cpu_share  # noqa: F401


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
    (_, jout), (gc, gr) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
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


def test_global_head_train_sample_with_the_jax_masks():
    gcfg = dataclasses.replace(CFG.global_head, in_channels=16, fc_out_channels=32)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 7, 7, 16)).astype(np.float32)
    jm = jglobal.GlobalHead(gcfg)
    key = jax.random.PRNGKey(12)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(13), jnp.asarray(x), train=False,
                          rng=key), 11)
    ref = jitted(jm.apply, v, jnp.asarray(x), train=True, rng=key)
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
