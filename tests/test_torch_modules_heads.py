"""``tests/test_torch_modules.py``'s global head on injected masks, and the NOC
head, in a file of at most 3 tests (xdist hands it out late); that file states
the tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monorun_tpu.models import global_head as jglobal
from monorun_tpu.models import noc_head as jnoc
from monorun_tpu_torch.models import global_head as tglobal
from monorun_tpu_torch.models import noc_head as tnoc

from test_torch_modules import (
    CFG, TCFG, _close, _load, _nhwc_feats, _randomize, _t, jax_mc_masks, jitted,
)
from torch_share import cpu_share  # noqa: F401


def test_global_head_with_injected_masks():
    gcfg = dataclasses.replace(CFG.global_head, in_channels=16,
                               fc_out_channels=32, mc_samples=5)
    x = _nhwc_feats(10, [(6, 7, 7, 16)])[0]
    jm = jglobal.GlobalHead(gcfg)
    key = jax.random.PRNGKey(4)
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(5), jnp.asarray(x), train=False, rng=key),
                   10)
    ref = jitted(jm.apply, v, jnp.asarray(x), train=False, rng=key)
    masks = jax_mc_masks(gcfg, key, 6, 16)
    tg = dataclasses.replace(TCFG.global_head, in_channels=16,
                             fc_out_channels=32, mc_samples=5)
    tm = _load(tglobal.GlobalHead(tg), v, "global_head", "roi_head.global_head.")
    with torch.no_grad():
        got = tm(_t(x), masks=tuple(_t(m) for m in masks))
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-5)

    labels = np.array([0, 2, 1, 1, 0, 2])
    jsl = jglobal.slice_pred(gcfg, ref.dim_latent_pred, ref.dim_latent_var,
                             jnp.asarray(labels))
    tsl = tglobal.slice_pred(tg, got.dim_latent_pred, got.dim_latent_var, _t(labels))
    for a, b in zip(tsl, jsl):
        _close(a, b)


def test_noc_head():
    ncfg = dataclasses.replace(CFG.noc_head, in_channels=16, conv_out_channels=16,
                               carafe_compressed_channels=8, roi_size=6, dense_size=12)
    x = _nhwc_feats(12, [(5, 6, 6, 16)])[0]
    latent = _nhwc_feats(13, [(5, 16)])[0]
    labels = np.array([0, 1, 2, 1, 0])
    flip = np.array([False, True, False, True, False])
    jm = jnoc.NOCHead(ncfg)
    args = (jnp.asarray(x), jnp.asarray(latent), jnp.asarray(labels), jnp.asarray(flip))
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(6), *args, train=False), 12)
    ref = jitted(jm.apply, v, *args, train=False)
    tcfg = dataclasses.replace(TCFG.noc_head, in_channels=16, conv_out_channels=16,
                               carafe_compressed_channels=8, roi_size=6, dense_size=12)
    tm = _load(tnoc.NOCHead(tcfg), v, "noc_head", "roi_head.noc_head.")
    with torch.no_grad():
        got = tm(_t(x), _t(latent), _t(labels), _t(flip))
    _close(got.noc_pred, ref.noc_pred, rtol=1e-4)
    _close(got.proj_logstd, ref.proj_logstd, rtol=1e-4)
