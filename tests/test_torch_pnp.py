"""The port's PnP solver and geometry against the JAX package's.

The problems are those of tests/test_pnp.py (noisy, outliers, degenerate,
coplanar, distant). RANSAC keys are the JAX draws
``jax.random.uniform(rng, (b, H, n))`` fed to both sides. Tolerances:
masks exact; poses and covariances to 1e-4 relative (float32 on both
sides; the LM loop compounds summation-order differences). The problems
are in files of at most 3 tests, which xdist hands out late (ROADMAP's
test-time budget): ``pnp_uncert`` without RANSAC in
``tests/test_torch_pnp_uncert.py``, with RANSAC in
``tests/test_torch_pnp_ransac.py``, the degenerate and coplanar problems and
the port's own draws in ``tests/test_torch_pnp_degenerate.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monorun_tpu.ops import geometry as jgeo
from monorun_tpu.ops import linalg_small as jla
from monorun_tpu.ops import pnp as jpnp
from monorun_tpu_torch.ops import geometry as tgeo
from monorun_tpu_torch.ops import linalg_small as tla
from monorun_tpu_torch.ops import pnp as tpnp

from test_pnp import _make_problem
from torch_share import cpu_share  # noqa: F401


def _close(got, ref, rtol=1e-4):
    got, ref = got.numpy(), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _args(p):
    names = ("uv", "istd", "pts", "cams", "ur", "vr")
    return [jnp.asarray(p[k]) for k in names], [torch.from_numpy(p[k]) for k in names]


def _compare(jres, tres, rtol=1e-4):
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(tres.inlier_mask.numpy(), np.asarray(jres.inlier_mask))
    _close(tres.yaw, jres.yaw, rtol)
    _close(tres.t_vec, jres.t_vec, rtol)
    _close(tres.pose_cov, jres.pose_cov, 1e-3)


def test_geometry_jacobians_and_hessians():
    p = _make_problem(b=3, n=32, seed=20, noise=0.5)
    ja, ta = _args(p)
    yaw, t = p["yaw"], p["t"] + 0.1
    mask = np.ones((3, 32), bool)
    mask[:, ::5] = False
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        jj, je = jax.jit(lambda *a: jgeo.jacobian_and_error(*a[:6], 0.5, *a[6:]))(
            *ja, jnp.asarray(yaw), jnp.asarray(t), jm)
        tj, te = tgeo.jacobian_and_error(*ta, 0.5, torch.from_numpy(yaw),
                                         torch.from_numpy(t), tm)
        _close(tj, jj, 1e-5)
        _close(te, je, 1e-5)
        for fn in ("approx_hessian", "exact_hessian"):
            ref = jax.jit(lambda *a, fn=fn: getattr(jgeo, fn)(*a[:6], 0.5, *a[6:]))(
                *ja, jnp.asarray(yaw), jnp.asarray(t), jm)
            got = getattr(tgeo, fn)(*ta, 0.5, torch.from_numpy(yaw),
                                    torch.from_numpy(t), tm)
            _close(got, ref, 1e-4)


def test_spd_helpers_flag_instead_of_raising():
    rng = np.random.default_rng(21)
    a = rng.normal(size=(5, 4, 4)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(4, dtype=np.float32)
    spd[1] = 0.0                                   # singular
    spd[2, 0, 0] = np.nan                          # non-finite
    spd[3] = -np.eye(4)                            # negative definite
    got_v = tla.spd_valid(torch.from_numpy(spd)).numpy()
    ref_v = np.asarray(jla.spd_valid(jnp.asarray(spd)))
    np.testing.assert_array_equal(got_v, ref_v)
    assert got_v.tolist() == [True, False, False, False, True]
    inv = tla.spd_inverse(torch.from_numpy(spd))
    ref = np.asarray(jla.spd_inverse(jnp.asarray(spd)))
    ok = ref_v
    _close(inv[torch.from_numpy(ok.copy())], ref[ok], 1e-4)
    # the failed matrices give what the JAX version gives, not an exception
    np.testing.assert_array_equal(np.isnan(inv.numpy()), np.isnan(ref))
    b = rng.normal(size=(4, 5)).astype(np.float32)
    packed = np.transpose(spd[[0, 4]], (1, 2, 0))
    _close(tla.spd_solve_packed(torch.from_numpy(packed), torch.from_numpy(b[:, :2])),
           jla.spd_solve_packed(jnp.asarray(packed), jnp.asarray(b[:, :2])))


CASES = {
    "noisy": dict(b=3, n=48, seed=1, noise=1.0),
    "outliers": dict(b=3, n=64, seed=2, noise=0.5, outlier_frac=0.25),
    "high_outliers": dict(b=3, n=64, seed=11, noise=0.5, outlier_frac=0.4),
}


def check_pnp_uncert(case, ransac):
    """``pnp_uncert`` of both packages on ``CASES[case]``, with RANSAC on the
    JAX draws or without (``tests/test_torch_pnp_ransac.py`` runs the
    RANSAC cases)."""
    p = _make_problem(**CASES[case])
    ja, ta = _args(p)
    b, n = p["uv"].shape[:2]
    cfg_j, cfg_t = jpnp.PnPConfig(), tpnp.PnPConfig()
    if not ransac:
        jres = jax.jit(lambda *a: jpnp.pnp_uncert(*a, cfg=cfg_j))(*ja)
        tres = tpnp.pnp_uncert(*ta, cfg=cfg_t)
    else:
        roi_h = np.ptp(p["uv"][:, :, 1], axis=1).astype(np.float32)
        thr = 0.2 * roi_h
        rng = jax.random.PRNGKey(7)
        keys = np.array(jax.random.uniform(rng, (b, cfg_j.ransac_hypotheses, n)))
        jres = jax.jit(lambda t, r, *a: jpnp.pnp_uncert(*a, ransac_thr=t, rng=r, cfg=cfg_j))(
            jnp.asarray(thr), rng, *ja)
        tres = tpnp.pnp_uncert(*ta, ransac_thr=torch.from_numpy(thr),
                               ransac_keys=torch.from_numpy(keys), cfg=cfg_t)
    assert tres.valid.all()
    _compare(jres, tres)
