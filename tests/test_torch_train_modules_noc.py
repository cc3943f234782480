"""``tests/test_torch_train_modules.py``'s NOC head dropout, dense NOC targets
and the coders' encodes, in a file of at most 3 tests (xdist hands it out
late); that file states the tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from monorun_tpu import coders as jcoders
from monorun_tpu.models import noc_head as jnoc
from monorun_tpu.targets import dense_target as jdense
from monorun_tpu_torch import coders as tcoders
from monorun_tpu_torch.models import noc_head as tnoc
from monorun_tpu_torch.targets import dense_target as tdense

from test_torch_modules import _load, _randomize, jitted
from test_torch_train_modules import CFG, TCFG, _boxes, _close, _t
from torch_share import cpu_share  # noqa: F401


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
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(16), *args, train=False), 14)
    ref = jitted(jm.apply, v, *args, train=True, rng=key)
    keep = jax.random.bernoulli(key, 0.5, (n, 1, 1, 16)).reshape(n, 16)
    tcfg = dataclasses.replace(TCFG.noc_head, in_channels=16, conv_out_channels=16,
                               carafe_compressed_channels=8, roi_size=6, dense_size=12,
                               dropout2d_rate=0.5)
    tm = _load(tnoc.NOCHead(tcfg), v, "noc_head", "roi_head.noc_head.")
    got = tm(*map(_t, (x, latent, labels, flip)), dropout_keep=_t(keep))
    _close(got.noc_pred, ref.noc_pred, 1e-4)
    _close(got.proj_logstd, ref.proj_logstd, 1e-4)


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
