"""``tests/test_torch_train_modules.py``'s calibration of a nearly singular
covariance, and the guards of the multivariate KL loss, in a file of at most 3
tests (xdist hands it out late); that file states the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu import losses as jlosses
from monorun_tpu_torch import losses as tlosses

from test_torch_train_modules import NEAR_SINGULAR, _close, _grads_match, _inv_covs, _t
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("weight", [0.0, 0.01])
def test_calibration_inverse_of_a_nearly_singular_covariance(weight):
    """The calibration loss's inverse covariance (``calibration_inv_cov``)
    on an ordinary and a nearly singular covariance: the JAX package's loss
    values, and its gradient on the ordinary rows; where the JAX package's
    gradient is NaN (the singular row, whose loss is 0), the port's is 0."""
    from monorun_tpu.ops.linalg_small import spd_inverse as jinv
    from monorun_tpu_torch.models.detector import calibration_inv_cov

    rng = np.random.default_rng(5)
    m = rng.normal(size=(2, 4, 4)).astype(np.float32)
    cov = np.concatenate([m[:1] @ m[:1].transpose(0, 2, 1) + 0.1 * np.eye(4, dtype=np.float32),
                          NEAR_SINGULAR[None],
                          m[1:] @ m[1:].transpose(0, 2, 1) + 0.1 * np.eye(4, dtype=np.float32)])
    diff = rng.normal(size=(3, 4)).astype(np.float32)
    w = np.array([[1.0], [0.0], [1.0]], np.float32)
    ok = np.ones(3, bool)

    def jloss(c):
        inv = jinv(jnp.where(jnp.asarray(ok)[:, None, None], c, 0.0) + jnp.eye(4))
        return jlosses.kl_loss_mv(jnp.asarray(diff), 0, inv, weight=jnp.asarray(w)) * weight

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(cov))
    tc = _t(cov).requires_grad_()
    tl = tlosses.kl_loss_mv(_t(diff), 0, calibration_inv_cov(tc, torch.from_numpy(ok)),
                            weight=_t(w)) * weight
    tg, = torch.autograd.grad(tl, tc)
    _close(tl, jl, 1e-6)
    assert not np.isfinite(np.asarray(jg)[1]).all()
    assert torch.isfinite(tg).all() and not tg[1].any()
    _close(tg[[0, 2]], np.asarray(jg)[[0, 2]], 1e-5)


def test_kl_loss_mv_guards():
    rng = np.random.default_rng(2)
    n = 8
    inv = _inv_covs(rng, n)
    diff = rng.normal(size=(n, 4)).astype(np.float32)
    w = (rng.uniform(size=(n, 1)) > 0.2).astype(np.float32)
    _grads_match(lambda d, ic: jlosses.kl_loss_mv(d, 0, ic, weight=jnp.asarray(w)),
                 lambda d, ic: tlosses.kl_loss_mv(d, 0, ic, weight=_t(w)), [diff, inv],
                 rtol=1e-5)
