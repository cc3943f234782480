"""``tests/test_torch_train_step.py``'s refined re-assign and debug branches,
in a file of at most 3 tests (xdist hands it out late); the JAX reference is
built once per run (``test_torch_train_step.py:jax_step``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models.detector import MonoRUn as JMonoRUn
from monorun_tpu.models.detector import _train_forward
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import MonoRUn

from test_torch_train_step import AFTER_PNP, LOSSES, both, tiny_train_config  # noqa: F401
from torch_share import cpu_share  # noqa: F401


def test_refined_reassign_and_debug_branches_match(both):  # noqa: F811
    """train.refined_reassign (the cascade-style re-assign and re-sample
    against the class-refined boxes) and train.debug (GT dims, NOC and a
    target-weight log-std downstream), together: every loss, port against
    JAX."""
    r = dataclasses.replace
    cfg = tiny_train_config(get_config)
    cfg = r(cfg, train=r(cfg.train, refined_reassign=True, debug=True))
    tcfg = tiny_train_config(tget_config)
    tcfg = r(tcfg, train=r(tcfg.train, refined_reassign=True, debug=True))
    ref = both["ref"]
    model = JMonoRUn(cfg)
    total, (jm, _) = jax.jit(lambda v, b: model.apply(
        v, b, jax.random.PRNGKey(1), ref["step"], ref["loss_ema"], method=_train_forward,
        mutable=["batch_stats"])[0])(
        jax.tree.map(jnp.asarray, ref["variables"]), jax.tree.map(jnp.asarray, ref["batch"]))
    tmodel = MonoRUn(tcfg)
    tmodel.load_state_dict(both["sd"])
    with torch.no_grad():
        ttotal, (tm, _) = tmodel.train_forward(both["tbatch"], torch.tensor(
            float(ref["loss_ema"])), both["draws"])
    for k in LOSSES + ("mean_iou",):
        rtol = 1e-3 if k in AFTER_PNP else 1e-5
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                   atol=rtol * max(abs(float(jm[k])), 1e-5), err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(total), rtol=1e-5)
    # the branches changed what the 3D heads train on
    assert float(tm["loss_dim"]) != float(both["tmetrics"]["loss_dim"])
