"""The single-class preset served whole, port against JAX, at a tiny
configuration.

``tests/test_torch_serve.py``'s case at ``kitti_car``: ``serve_raw`` of
both packages on the same uint8 canvases, intrinsics and weights, with
JAX's MC-dropout masks and RANSAC keys injected into the port. So the car
anchors, the 2-logit bbox head, the one-class global head and
``DimCoder``, the class-agnostic NOC head and the label clamp all run
inside one forward. The JAX side is computed once per test run under one
``jax.jit`` (``run_shared``, keyed by the preset and every size).
Tolerances as there: labels and validity exact; 2D boxes and scores to
1e-5 of their scale; 3D boxes, covariances and debug maps to 1e-3.

The PnP is held in two parts. Its inputs (the 2D grid, its inverse
std, the 3D points, the intrinsics, the ranges and the RANSAC threshold)
to 1e-3 of their scale; then the port's forward goes on from JAX's PnP
result, as it takes JAX's draws, so the calibration, the score head and
the 3D NMS are held on the same poses. The port's own solve on JAX's
inputs is held to JAX's solve (pose to 1e-3 of its scale, validity
exactly), and its covariance to the float64 solve of the same inputs
(1e-3 of its scale). ``tests/test_torch_pnp.py:_compare`` holds the
port's covariance to JAX's at 1e-3 on well-determined problems. Last, the
port's forward on its own PnP, un-injected, is held to JAX's whole
forward, and the port's solve's covariance to JAX's, at ``GROSS``, 5e-3
of scale: above what the float32 solve spreads here (2.08e-3 for the 3D
boxes and the covariances, 2.33e-3 for the solve's covariance), below a
gross error of the port's PnP. Why: at random weights a slot's pose is barely
determined, and the float32 solve turns its inputs' rounding into more
than the 3D tolerance. On one slot here (posterior depth std 56 m at
33 m) a 1e-6 relative change of the 3D points moves the depth by 0.025 m
and JAX's own solve moves 0.016 m between ``jax.jit`` and eager; the
whole forwards on each package's own inputs differ there by 0.069 m,
2.1e-3 of the boxes' scale. On another, JAX's covariance under
``jax.jit`` is 1.02e-3 of its scale from the float64 solve, JAX eager
1.05e-3 from JAX under ``jax.jit``, the port 0.83e-3 from float64
(ROADMAP Queue 3 item 12).

Last, the entry point at batch 1, the reference's test-time batch. One
test, so that xdist hands this file out last, after the JAX package's
long tests other than ``tests/test_train_step.py`` have ended (ROADMAP's
test-time budget).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from monorun_tpu_torch.apis.inference import init_inference
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.ops.pnp import PnPResult, pnp_uncert

from test_torch_serve import B, H, W, _close, _inputs, jax_serve, port_serve, tiny_config
from torch_share import cpu_share, run_shared  # noqa: F401

PRESET = "kitti_car"
GROSS = 5e-3
JAX_SERVE = (f"tiny_config({PRESET}): float32, ResNet-26, neck 64, 2 MC samples, "
             f"B {B}, {H}x{W}, 64 proposals, 12 slots of which 6 head slots, debug; "
             "_inputs(seed 0), init_detector(PRNGKey(0), fast), _randomize(seed 0), "
             "serve key PRNGKey(1)")


@pytest.fixture(scope="module")
def both():
    ref = run_shared(f"test_torch_car_serve.jax_serve: {JAX_SERVE}, with the PnP",
                     lambda: jax_serve(PRESET, pnp=True))
    record = []
    tdet = port_serve(PRESET, ref, record)
    assert len(record) == 1
    own = port_serve(PRESET, {k: v for k, v in ref.items() if k != "pnp"})
    return SimpleNamespace(**ref["det"]), tdet, ref["pnp"], record[0], own


def test_serve_raw_matches_jax(both):
    """Labels and validity exactly (real detections in both images, every
    one a car, none past the head slots); the PnP's inputs, the port's
    solve on JAX's, the 2D and 3D outputs, covariances and debug maps at
    the module docstring's tolerances; the port's forward on its own PnP
    and its solve's covariance at ``GROSS``; then ``init_inference`` of the tiny
    ``kitti_car`` with seeded weights at batch 1: one canvas in, finite
    fixed-shape detections out, every valid label the car's."""
    jdet, tdet, jpnp, tpnp, own = both
    np.testing.assert_array_equal(tdet.labels.numpy(), np.asarray(jdet.labels))
    np.testing.assert_array_equal(tdet.valid.numpy(), np.asarray(jdet.valid))
    cfg = tiny_config(tget_config, PRESET)
    K, M = cfg.test.head_slots, cfg.test.max_per_img
    valid = tdet.valid.numpy()
    assert valid[:, :K].sum(1).min() >= 2 and not valid[:, K:].any()
    assert (tdet.labels.numpy()[valid] == 0).all()

    assert len(tpnp["inputs"]) == len(jpnp["inputs"]) == 7
    for got, ref in zip(tpnp["inputs"], jpnp["inputs"]):
        _close(got, ref, 1e-3)
    jres = PnPResult(*jpnp["result"])
    solve = tpnp["solve"]
    np.testing.assert_array_equal(solve.valid.numpy(), jres.valid)
    _close(solve.t_vec, jres.t_vec, 1e-3)
    _close(solve.yaw, jres.yaw, 1e-3)
    *args, thr = (torch.from_numpy(np.array(a, np.float64)) for a in jpnp["inputs"])
    kw = tpnp["keywords"]
    solve64 = pnp_uncert(*args, **dict(kw, ransac_thr=thr,
                                       ransac_keys=kw["ransac_keys"].double()))
    _close(solve.pose_cov.double(), solve64.pose_cov, 1e-3)
    _close(tdet.bboxes_2d, jdet.bboxes_2d, 1e-5)
    _close(tdet.scores_2d, jdet.scores_2d, 1e-5)
    _close(tdet.bboxes_3d, jdet.bboxes_3d, 1e-3)
    _close(tdet.pose_cov, jdet.pose_cov, 1e-3)
    for k in ("oc_maps", "std_maps", "latent_vecs"):
        _close(tdet.extras[k], jdet.extras[k], 1e-3)
    np.testing.assert_array_equal(own.labels.numpy(), np.asarray(jdet.labels))
    np.testing.assert_array_equal(own.valid.numpy(), np.asarray(jdet.valid))
    _close(solve.pose_cov, jres.pose_cov, GROSS)
    _close(own.bboxes_3d, jdet.bboxes_3d, GROSS)
    _close(own.pose_cov, jdet.pose_cov, GROSS)

    sess = init_inference(cfg, batch_size=1, device="cpu", seed=3, raw=True)
    raw, cam, shapes = (a[:1] for a in _inputs(seed=4))
    det = sess.run(raw, cam, shapes)
    assert det.bboxes_3d.shape == (1, M, 8) and det.labels.shape == (1, M)
    assert torch.isfinite(det.bboxes_3d).all() and torch.isfinite(det.pose_cov).all()
    assert (det.labels[det.valid] == 0).all() and not det.valid[:, K:].any()
