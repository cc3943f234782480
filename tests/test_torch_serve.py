"""The whole serving slice, port against JAX, at a tiny configuration.

``MonoRUn.serve_raw`` of both packages on the same uint8 canvases,
intrinsics and weights (JAX variables with non-trivial values, carried
over by ``from_jax_params``), with the same MC-dropout masks and RANSAC
keys (the JAX draws, computed here with the JAX calls and injected into
the port). float32, ResNet-26, 64-wide neck, 2 MC samples, 64x128 canvas,
with the head-slot cut (6 of 12 slots) and the debug maps on.

Tolerances: labels and validity masks exact; 2D boxes and scores to 1e-5
of their scale (summation order); 3D boxes, debug maps and covariances to
1e-3 (relative and of the output's scale), since the 8 LM iterations of
the PnP solve compound float32 summation-order differences.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models import detector as jdetector
from monorun_tpu.models import init_detector
from monorun_tpu.ops.pnp import pnp_uncert as jpnp_uncert
from monorun_tpu_torch.apis.inference import InferenceSession, init_inference
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models import detector as tdetector
from monorun_tpu_torch.models.detector import HeadDraws, MonoRUn
from monorun_tpu_torch.ops.pnp import PnPResult
from monorun_tpu_torch.ops.pnp import pnp_uncert as tpnp_uncert
from monorun_tpu_torch.utils.weights import from_jax_params

from test_torch_modules import _randomize, jax_mc_masks
from torch_share import cpu_share  # noqa: F401

B, H, W = 2, 64, 128


def tiny_config(get_cfg, preset="kitti_multiclass"):
    """dryrun-style tiny config of ``preset`` (either package's)."""
    cfg = get_cfg(preset)
    r = dataclasses.replace
    return r(
        cfg, compute_dtype="float32",
        backbone=r(cfg.backbone, depth=26),
        neck=r(cfg.neck, out_channels=64),
        rpn=r(cfg.rpn, feat_channels=64),
        bbox_head=r(cfg.bbox_head, in_channels=64, fc_out_channels=128),
        global_head=r(cfg.global_head, mc_samples=2, in_channels=64,
                      fc_out_channels=128),
        noc_head=r(cfg.noc_head, in_channels=64, conv_out_channels=64,
                   carafe_compressed_channels=16, roi_size=8, dense_size=16),
        score_head=r(cfg.score_head, reg_fc_out_channels=128,
                     pose_fc_out_channels=128, fc_out_channels=64),
        pose_head=r(cfg.pose_head, ransac_hypotheses=4),
        test=r(cfg.test, rpn_nms_pre=64, rpn_nms_post=64, max_per_img=12,
               head_slots=6, debug=True),
        data=r(cfg.data, pad_height=H, pad_width=W, raw_height=H, raw_width=W),
    )


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    cam = np.tile(np.array([[70.0, 0, 64], [0, 70.0, 32], [0, 0, 1]], np.float32),
                  (B, 1, 1))
    shapes = np.array([[60.0, 120.0], [64.0, 128.0]], np.float32)
    return raw, cam, shapes


def jax_variables(cfg):
    _, variables = init_detector(cfg, jax.random.PRNGKey(0), (H, W), fast=True)
    return _randomize(variables)


def jax_serve(preset, pnp=False):
    """JAX's ``serve_raw`` of the tiny ``preset`` on ``_inputs()``: its
    randomized variables, its detections (a dict of arrays) and its draws,
    which ``heads_forward`` splits from the key into MC and PnP keys. With
    ``pnp``, also what JAX's forward hands ``pnp_uncert`` (its six
    positional inputs, then ``ransac_thr``) and what it gets back, returned
    by the same ``jax.jit`` program."""
    cfg = tiny_config(get_config, preset)
    model, _ = init_detector(cfg, jax.random.PRNGKey(0), (H, W), fast=True)
    variables = jax_variables(cfg)
    raw, cam, shapes = _inputs()
    key = jax.random.PRNGKey(1)
    stash = []

    def spy(*args, **kw):
        res = jpnp_uncert(*args, **kw)
        stash.append(dict(inputs=args + (kw["ransac_thr"],), result=tuple(res)))
        return res

    def serve(v, a, c, s, k):
        return model.apply(v, a, c, s, k, method=model.serve_raw), stash[:1]

    with pytest.MonkeyPatch.context() as mp:
        if pnp:
            mp.setattr(jdetector, "pnp_uncert", spy)
        jdet, captured = jax.jit(serve)(variables, jnp.asarray(raw), jnp.asarray(cam),
                                        jnp.asarray(shapes), key)

    rng_mc, rng_pnp = jax.random.split(key)
    K = cfg.test.head_slots
    masks = jax_mc_masks(cfg.global_head, rng_mc, B * K, cfg.neck.out_channels)
    n_pts = cfg.noc_head.dense_size ** 2
    keys = np.array(jax.random.uniform(
        rng_pnp, (B * K, cfg.pose_head.ransac_hypotheses, n_pts)))
    out = dict(variables=jax.tree.map(np.asarray, variables),
               det=jax.tree.map(np.asarray, jdet._asdict()), masks=masks, keys=keys)
    if pnp:
        out["pnp"] = jax.tree.map(np.asarray, captured[0])
    return out


def port_serve(preset, ref, record=None):
    """The port's ``serve_raw`` of the tiny ``preset`` on the same inputs,
    weights and draws as ``jax_serve``'s ``ref``. Where ``ref`` holds JAX's
    ``pnp``, the port's forward takes JAX's PnP result in place of its own
    solve, as it takes JAX's draws; ``record`` gets what the port would
    have handed the PnP (its inputs, then its keywords) and the port's own
    solve on JAX's inputs."""
    variables = ref["variables"]
    raw, cam, shapes = _inputs()
    draws = HeadDraws(tuple(torch.from_numpy(np.array(m)) for m in ref["masks"]),
                      torch.from_numpy(np.array(ref["keys"])))
    tmodel = MonoRUn(tiny_config(tget_config, preset))
    tmodel.load_state_dict(from_jax_params(variables["params"],
                                           variables["batch_stats"]))

    def on_jax_pnp(*args, **kw):
        *jargs, thr = (torch.from_numpy(np.array(a)) for a in ref["pnp"]["inputs"])
        record.append(dict(inputs=args + (kw["ransac_thr"],), keywords=kw,
                           solve=tpnp_uncert(*jargs, **dict(kw, ransac_thr=thr))))
        return PnPResult(*(torch.from_numpy(np.array(a)) for a in ref["pnp"]["result"]))

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        if "pnp" in ref:
            mp.setattr(tdetector, "pnp_uncert", on_jax_pnp)
        return tmodel.eval().serve_raw(
            torch.from_numpy(raw), torch.from_numpy(cam), torch.from_numpy(shapes),
            draws,
        )


@pytest.fixture(scope="module")
def both():
    ref = jax_serve("kitti_multiclass")
    return SimpleNamespace(**ref["det"]), port_serve("kitti_multiclass", ref)


def _close(got, ref, rtol):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def test_discrete_outputs_match_exactly(both):
    jdet, tdet = both
    np.testing.assert_array_equal(tdet.labels.numpy(), np.asarray(jdet.labels))
    np.testing.assert_array_equal(tdet.valid.numpy(), np.asarray(jdet.valid))
    # the case exercises real detections in both images and the slot cut
    valid = tdet.valid.numpy()
    assert valid[:, :6].sum(1).min() >= 2 and not valid[:, 6:].any()


def test_continuous_outputs_match(both):
    jdet, tdet = both
    _close(tdet.bboxes_2d, jdet.bboxes_2d, 1e-5)
    _close(tdet.scores_2d, jdet.scores_2d, 1e-5)
    _close(tdet.bboxes_3d, jdet.bboxes_3d, 1e-3)
    _close(tdet.pose_cov, jdet.pose_cov, 1e-3)
    for k in ("oc_maps", "std_maps", "latent_vecs"):
        _close(tdet.extras[k], jdet.extras[k], 1e-3)


def test_init_inference_session_on_cpu():
    """The entry point with ``raw=True``: seeded random weights, explicit
    CPU, uint8 in, fixed-shape detections out; a CUDA request without a
    GPU raises."""
    cfg = tiny_config(tget_config)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_inference(cfg, batch_size=B)
    sess = init_inference(cfg, batch_size=B, device="cpu", seed=3, raw=True)
    assert isinstance(sess, InferenceSession)
    raw, cam, shapes = _inputs(seed=4)
    det = sess.run(raw, cam, shapes)
    M = cfg.test.max_per_img
    assert det.bboxes_3d.shape == (B, M, 8) and det.pose_cov.shape == (B, M, 4, 4)
    assert det.valid.dtype == torch.bool and det.labels.shape == (B, M)
    assert torch.isfinite(det.bboxes_3d).all() and torch.isfinite(det.pose_cov).all()
    # same seed, same weights and draws: the same detections
    det2 = init_inference(cfg, batch_size=B, device="cpu", seed=3,
                          raw=True).run(raw, cam, shapes)
    torch.testing.assert_close(det2.bboxes_3d, det.bboxes_3d, rtol=0, atol=0)
