"""``tests/test_torch_modules.py``'s RPN head with its proposals, the bbox head
with its detections, and the coders' decodes, in a file of at most 3 tests
(xdist hands it out late); that file states the tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monorun_tpu import coders as jcoders
from monorun_tpu.models import bbox_head as jbbox
from monorun_tpu.models import rpn as jrpn
from monorun_tpu_torch import coders as tcoders
from monorun_tpu_torch.models import bbox_head as tbbox
from monorun_tpu_torch.models import rpn as trpn

from test_torch_modules import (
    CFG, TCFG, _close, _load, _nhwc_feats, _randomize, _small_head_cfg, _t, jitted,
)
from torch_share import cpu_share  # noqa: F401


def test_rpn_head_and_proposals():
    feats = _nhwc_feats(8, [(2, 16, 32, 16), (2, 8, 16, 16), (2, 4, 8, 16),
                            (2, 2, 4, 16), (2, 1, 2, 16)])
    jm = jrpn.RPNHead(feat_channels=16, num_anchors=3)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats]), 8)
    jc, jr = jitted(jm.apply, v, [jnp.asarray(f) for f in feats])
    tm = _load(trpn.RPNHead(16, 16, 3), v, "rpn_head", "rpn_head.")
    with torch.no_grad():
        tc, tr = tm([_t(f) for f in feats])
    for a, b in zip(tc + tr, jc + jr):
        _close(a, b, rtol=1e-4)
    # proposals from the same (JAX) head outputs on both sides
    shapes = np.array([[60.0, 120.0], [64.0, 128.0]], np.float32)
    rcfg = dataclasses.replace(CFG.rpn, nms_thr=0.7)
    ref = jitted(lambda c, r, v: jrpn.get_proposals(c, r, rcfg, (64, 128), 40, 50,
                                                    valid_shapes=v), jc, jr, jnp.asarray(shapes))
    got = trpn.get_proposals([_t(c) for c in jc], [_t(r) for r in jr],
                             dataclasses.replace(TCFG.rpn, nms_thr=0.7),
                             (64, 128), 40, 50, valid_shapes=_t(shapes))
    _close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_bbox_head_and_det_bboxes():
    x = _nhwc_feats(9, [(12, 7, 7, 16)])[0]
    jm = jbbox.BBoxHead(_small_head_cfg(CFG))
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(3), jnp.asarray(x)), 9)
    jc, jd = jitted(jm.apply, v, jnp.asarray(x))
    tm = _load(tbbox.BBoxHead(_small_head_cfg(TCFG)), v, "bbox_head",
               "roi_head.bbox_head.")
    with torch.no_grad():
        tc, td = tm(_t(x))
    _close(tc, jc, rtol=1e-4)
    _close(td, jd, rtol=1e-4)

    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 80, (12, 2))
    rois = np.concatenate([xy, xy + rng.uniform(5, 40, (12, 2))], 1).astype(np.float32)
    valid = np.ones(12, bool)
    valid[-2:] = False
    logits = np.asarray(jc) * 3.0
    deltas = np.asarray(jd)
    ref = jbbox.get_det_bboxes(jnp.asarray(rois), jnp.asarray(logits),
                               jnp.asarray(deltas), jnp.asarray(valid), (64, 128),
                               CFG.bbox_head, 0.05, 0.5, 8)
    got = tbbox.get_det_bboxes(_t(rois), _t(logits), _t(deltas), _t(valid),
                               (64, 128), TCFG.bbox_head, 0.05, 0.5, 8)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_coders_decode():
    rng = np.random.default_rng(0)
    n = 6
    labels = rng.integers(0, 3, n)
    dim = rng.normal(size=(n, 3)).astype(np.float32)
    dim_var = rng.uniform(0.1, 1, (n, 3)).astype(np.float32)
    jd = jcoders.DimCoder().decode(jnp.asarray(dim), jnp.asarray(dim_var), jnp.asarray(labels))
    td = tcoders.DimCoder().decode(_t(dim), _t(dim_var), _t(labels))
    for a, b in zip(td, jd):
        _close(a, b)

    part = rng.normal(size=(n, 4, 4, 3)).astype(np.float32)
    flip = np.zeros(n, bool)
    dims = np.asarray(jd[0])
    dvar = np.asarray(jd[1])
    jn = jcoders.NOCCoder().decode(jnp.asarray(part), None, jnp.asarray(dims),
                                   jnp.asarray(dvar), jnp.asarray(flip))
    tn = tcoders.NOCCoder().decode(_t(part), None, _t(dims), _t(dvar), _t(flip))
    for a, b in zip(tn, jn):
        _close(a, b)

    logstd = rng.normal(size=(n, 4, 4, 2)).astype(np.float32)
    dist = rng.uniform(1, 40, (n, 1)).astype(np.float32)
    jp, tp = jcoders.ProjErrorCoder(), tcoders.ProjErrorCoder()
    for cvar, d in ((np.asarray(jn[1]), None), (None, dist), (None, None)):
        ref = jp.decode_logstd(jnp.asarray(logstd),
                               None if cvar is None else jnp.asarray(cvar),
                               None if d is None else jnp.asarray(d))
        got = tp.decode_logstd(_t(logstd), None if cvar is None else _t(cvar),
                               None if d is None else _t(d))
        _close(got, ref)
    cov = rng.normal(size=(n, 4, 4)).astype(np.float32)
    _close(tp.cov_correction(_t(cov), _t(dist[:, 0])),
           jp.cov_correction(jnp.asarray(cov), jnp.asarray(dist[:, 0])))
