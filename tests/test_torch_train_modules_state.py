"""``tests/test_torch_train_modules.py``'s group clip, train state and the
score head's smooth BatchNorm, in a file of at most 3 tests (xdist hands it out
late); that file states the tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu import train as jtrain
from monorun_tpu.models import score_head as jscore
from monorun_tpu_torch import train as ttrain
from monorun_tpu_torch.models import score_head as tscore

from test_torch_modules import _load, _randomize, jitted
from test_torch_train_modules import CFG, TCFG, TREE, _close, _nest, _t, _tree
from torch_share import cpu_share  # noqa: F401


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
    v = _randomize(jitted(jm.init, jax.random.PRNGKey(18), *map(jnp.asarray, ins)), 17)
    tcfg = dataclasses.replace(TCFG.score_head, reg_fc_out_channels=32,
                               pose_fc_out_channels=32, fc_out_channels=16)
    for valid in (rng.uniform(size=n) > 0.3, np.eye(n, dtype=bool)[2]):
        ref, upd = jitted(jm.apply, v, *map(jnp.asarray, ins), train=True,
                          valid=jnp.asarray(valid), mutable=["batch_stats"])
        tm = _load(tscore.ScoreHead(tcfg), v, "score_head", "roi_head.score_head.")
        got = tm(*map(_t, ins), train=True, valid=_t(valid))
        _close(got, ref, 1e-5)
        stats = upd["batch_stats"]["pose_norm"]
        _close(tm.pose_norm.running_mean, stats["mean"], 1e-5)
        _close(tm.pose_norm.running_var, stats["var"], 1e-5)
