"""The fast serving presets, port against JAX, at their structural cuts.

The five ``kitti_multiclass_fast*`` presets (``config.py:_fast``,
``_fast2``, ``_fast3_r50``) cut the serving program where no other port
test reaches: the test-time downscale (``test_scale`` 0.75 and 0.625, the
image resized on the device inside a smaller pad), the proposal count,
ResNet-50, fewer head slots and MC samples, and ``dense_size ==
roi_size``: the NOC decoder without CARAFE and a ``roi_size**2``-point
PnP. Each rung is shrunk here to CPU size (narrow widths, a few
proposals) keeping its own cuts, and ``serve_raw`` of both packages runs
on the same uint8 canvases with ``_randomize``d JAX variables carried over
by ``from_jax_params`` and JAX's MC masks and RANSAC keys injected as
``HeadDraws`` (one JAX compile per rung). Then one training step at
``dense_size == roi_size`` against ``jax.grad`` of ``_train_forward``;
the checks of ``tests/test_fast_preset.py``, each against the JAX
package on the same inputs; and ResNet-50's weights through
``utils/weights.py`` both ways.

The align's 2048-RoI switch (JAX's band kernel at or above it in
bfloat16, the sorted kernel below): on the CPU both packages take the
gather version at any count, so the switch is held where it is decided.
The port's ``align_choice`` against JAX's own dispatcher (run with the
backend reported as the TPU and its kernels replaced by spies) at the
rungs' proposal counts; and the ``_fast3_r50`` rung served with the port's
``BAND_MIN_ROIS`` patched so that its B x proposals sit at and below it.

Tolerances, as ``tests/test_torch_serve.py`` and
``tests/test_torch_train_step.py`` state them: labels and validity masks
exact; 2D boxes and scores to 1e-5 of their scale; 3D boxes, covariances
and debug maps to 1e-3; losses to 1e-5 relative (1e-3 after the PnP);
each gradient to 1e-4 of its leaf's largest entry; weights bit for bit.

This file keeps the light cases. Each JAX side (a rung's variables and
``serve_raw``, the no-CARAFE step) and the port's step are computed once
per test run (``tests/torch_share.py:run_shared``), and the heavy cases
are in files of at most 3 tests, which xdist hands out late:
``test_torch_fast_presets_serve{,_maps,_fast}.py``,
``test_torch_fast_presets_step.py`` (3 tests, which build the step) with
``test_torch_fast_presets_step_{rpn,cls,heads,pose,score}.py`` (at most 2,
which read it and go out after every file of 3), and
``test_torch_fast_presets_r50.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorun_tpu.config import get_config
from monorun_tpu.models import init_detector
from monorun_tpu.models.detector import Detections as JDetections
from monorun_tpu.models.detector import MonoRUn as JMonoRUn
from monorun_tpu.models.detector import _train_forward
from monorun_tpu.ops import roi_align as jra
from monorun_tpu.train import create_train_state
from monorun_tpu.utils.synthetic import synthetic_train_batch
from monorun_tpu_torch.config import get_config as tget_config
from monorun_tpu_torch.models.detector import Detections, HeadDraws, MonoRUn
from monorun_tpu_torch.ops import roi_align as tra
from monorun_tpu_torch.utils.weights import from_jax_params, to_jax_leaves

from test_fast_preset import kitti_dir  # noqa: F401  (the fixture, shared)
from test_torch_eval import jax_native_built  # noqa: F401  (autouse)
from test_torch_modules import _randomize, jax_mc_masks
from test_torch_serve import _close
from test_torch_train_step import (AFTER_PNP, _flat, draw_arrays, draw_counts,
                                   jax_train_draws, tiny_train_config, train_draws_of)
from torch_share import cpu_share, pack, run_shared, unpack  # noqa: F401

B = 2
PRESETS = ("kitti_multiclass_fast", "kitti_multiclass_fast_r50", "kitti_multiclass_fast2",
           "kitti_multiclass_fast2_r50", "kitti_multiclass_fast3_r50")
# Each rung at CPU size. The base configuration of these tiny rungs is
# tests/test_torch_serve.py's (64 proposals, 6 of 12 head slots, 2 MC
# samples at 8x8 -> 16x16 NOC maps); each rung keeps its preset's
# test_scale and cuts what its preset cuts, in proportion: proposals
# 1000 -> 512 / 256 / 192 as 64 -> 32 / 16 / 12, head slots 48 -> 24 / 16
# as 6 -> 3 / 2, MC samples 50 -> 16 as 4 -> 2, and dense_size 28 -> 14
# (no CARAFE) as 16 -> 14 = roi_size. ResNet-50 stays ResNet-50.
RUNGS = {
    "fast": dict(preset="kitti_multiclass_fast", depth=26, raw=(80, 256), pad=(64, 192),
                 proposals=32, slots=6, mc=4, noc=(8, 16)),
    "fast2": dict(preset="kitti_multiclass_fast2", depth=26, raw=(80, 256), pad=(64, 192),
                  proposals=16, slots=3, mc=2, noc=(14, 14)),
    "fast3_r50": dict(preset="kitti_multiclass_fast3_r50", depth=50, raw=(96, 192),
                      pad=(64, 128), proposals=12, slots=2, mc=2, noc=(14, 14)),
}


def tiny_rung(get_cfg, rung):
    """The rung's preset (either package's) at CPU size."""
    s = RUNGS[rung]
    cfg = get_cfg(s["preset"])
    r = dataclasses.replace
    roi, dense = s["noc"]
    (h, w), (ph, pw) = s["raw"], s["pad"]
    return r(
        cfg, compute_dtype="float32",
        backbone=r(cfg.backbone, depth=s["depth"]),
        neck=r(cfg.neck, out_channels=64),
        rpn=r(cfg.rpn, feat_channels=64),
        bbox_head=r(cfg.bbox_head, in_channels=64, fc_out_channels=128),
        global_head=r(cfg.global_head, mc_samples=s["mc"], in_channels=64,
                      fc_out_channels=128),
        noc_head=r(cfg.noc_head, in_channels=64, conv_out_channels=64,
                   carafe_compressed_channels=16, roi_size=roi, dense_size=dense),
        score_head=r(cfg.score_head, reg_fc_out_channels=128,
                     pose_fc_out_channels=128, fc_out_channels=64),
        pose_head=r(cfg.pose_head, ransac_hypotheses=4),
        test=r(cfg.test, rpn_nms_pre=s["proposals"], rpn_nms_post=s["proposals"],
               max_per_img=12, head_slots=s["slots"], debug=True),
        train=r(cfg.train, dense_size=dense),
        data=r(cfg.data, pad_height=ph, pad_width=pw, raw_height=h, raw_width=w),
    )


def rung_inputs(rung, seed=0):
    """uint8 canvases with the images pasted top-left: the first image
    smaller than the canvas, the second filling it; native intrinsics with
    KITTI's focal length to width ratio (721.5 / 1242)."""
    h, w = RUNGS[rung]["raw"]
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (B, h, w, 3), np.uint8)
    f = 0.58 * w
    cam = np.tile(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32), (B, 1, 1))
    shapes = np.array([[h - 4.0, w - 16.0], [h, w]], np.float32)
    return raw, cam, shapes


def jax_variables(rung):
    """The rung's ``_randomize``d JAX variables, as arrays: one init per rung
    and test run (``run_shared``)."""
    def compute():
        cfg = tiny_rung(get_config, rung)
        _, variables = init_detector(cfg, jax.random.PRNGKey(0), RUNGS[rung]["pad"],
                                     fast=True)
        return _randomize(variables)

    return run_shared(f"test_torch_fast_presets.jax_variables: tiny_rung({rung!r}), "
                      "init_detector(PRNGKey(0), fast=True), _randomize(seed 0)", compute)


def serve_jax(rung, key):
    """JAX's ``serve_raw`` on the rung's inputs, and its draws as
    ``HeadDraws``: ``heads_forward`` splits its key into the MC and the
    PnP keys. Once per rung and test run (``run_shared``): the detections
    come back as a ``Detections`` of arrays."""
    def compute():
        cfg = tiny_rung(get_config, rung)
        variables = jax_variables(rung)
        model = JMonoRUn(cfg)
        raw, cam, shapes = rung_inputs(rung)
        jdet = jax.jit(
            lambda v, a, c, s, k: model.apply(v, a, c, s, k, method=model.serve_raw)
        )(variables, jnp.asarray(raw), jnp.asarray(cam), jnp.asarray(shapes), key)
        rng_mc, rng_pnp = jax.random.split(key)
        K = cfg.test.head_slots
        masks = jax_mc_masks(cfg.global_head, rng_mc, B * K, cfg.neck.out_channels)
        keys = np.array(jax.random.uniform(
            rng_pnp, (B * K, cfg.pose_head.ransac_hypotheses, cfg.noc_head.dense_size ** 2)))
        return dict(det=jax.tree.map(np.asarray, jdet._asdict()), masks=tuple(masks),
                    keys=keys)

    ref = run_shared(f"test_torch_fast_presets.serve_jax: tiny_rung({rung!r}), rung_inputs "
                     f"seed 0, jax_variables(PRNGKey(0), fast=True, _randomize seed 0), key "
                     f"{np.asarray(key).tolist()}", compute)
    draws = HeadDraws(tuple(torch.from_numpy(m.copy()) for m in ref["masks"]),
                      torch.from_numpy(ref["keys"]))
    return JDetections(**ref["det"]), draws


def serve_port(rung, draws):
    tmodel = MonoRUn(tiny_rung(tget_config, rung))
    variables = jax_variables(rung)
    tmodel.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    raw, cam, shapes = rung_inputs(rung)
    with torch.no_grad():
        return tmodel.eval().serve_raw(torch.from_numpy(raw), torch.from_numpy(cam),
                                       torch.from_numpy(shapes), draws)


def recording_choices(into):
    """``align_choice`` recording each call's RoI count and the route it
    would take on a CUDA device in bfloat16."""
    choose = tra.align_choice

    def spy(n, dtype, on_cuda):
        into.append((n, choose(n, torch.bfloat16, True).impl))
        return choose(n, dtype, on_cuda)

    return spy


def serve_rungs(rungs):
    """``rungs`` served by both packages (the JAX key of each, ``PRNGKey(1 +
    its place in RUNGS)``); ``_fast3_r50`` served by the port twice, with
    the switch at and just above its B x proposals (the band route's choice
    needs ``MONORUN_BAND_TIERED`` to differ from the sorted one's on the
    card). The served tests are in ``tests/test_torch_fast_presets_serve.py``,
    ``test_torch_fast_presets_serve_maps.py`` and
    ``test_torch_fast_presets_serve_fast.py``: files of at most 3 tests,
    which xdist hands out late (ROADMAP's test-time budget)."""
    out = {}
    for rung in rungs:
        jdet, draws = serve_jax(rung, jax.random.PRNGKey(1 + list(RUNGS).index(rung)))
        if rung != "fast3_r50":
            out[rung] = (jdet, serve_port(rung, draws))
            continue
        n = B * RUNGS[rung]["proposals"]
        for where, switch in (("at", n), ("below", n + 1)):
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tra, "BAND_MIN_ROIS", switch)
                mp.setenv("MONORUN_ALIGN_IMPL", "auto")
                mp.setenv("MONORUN_BAND_TIERED", "1")
                mp.setattr(tra, "align_choice", recording_choices(calls))
                out[f"{rung}_{where}"] = (jdet, serve_port(rung, draws), calls)
    return out


def check_served(jdet, tdet, case):
    """A served case against JAX's: labels and validity exact, 2D boxes and
    scores to 1e-5 of their scale, 3D boxes, covariances and debug maps to
    1e-3; real detections, and none past the head slots."""
    np.testing.assert_array_equal(tdet.labels.numpy(), np.asarray(jdet.labels))
    np.testing.assert_array_equal(tdet.valid.numpy(), np.asarray(jdet.valid))
    _close(tdet.bboxes_2d, jdet.bboxes_2d, 1e-5)
    _close(tdet.scores_2d, jdet.scores_2d, 1e-5)
    _close(tdet.bboxes_3d, jdet.bboxes_3d, 1e-3)
    _close(tdet.pose_cov, jdet.pose_cov, 1e-3)
    for k in ("oc_maps", "std_maps", "latent_vecs"):
        _close(tdet.extras[k], jdet.extras[k], 1e-3)
    rung = case.replace("_at", "").replace("_below", "")
    K = RUNGS[rung]["slots"]
    valid = tdet.valid.numpy()
    assert valid[:, :K].any() and not valid[:, K:].any()


def jax_route(monkeypatch, n, dtype):
    """The kernel JAX's ``multilevel_roi_align_auto`` calls on the TPU for
    ``n`` RoIs in ``dtype`` (the kernels replaced by spies)."""
    from monorun_tpu.ops import roi_align_band as jband
    from monorun_tpu.ops import roi_align_sorted as jsorted

    seen = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jband, "multilevel_roi_align_band",
                        lambda *a, **k: seen.append(
                            "bandmm" if k["matmul"] else
                            "tiered" if k["tiered"] else "band"))
    monkeypatch.setattr(jsorted, "multilevel_roi_align_sorted",
                        lambda *a, **k: seen.append("sorted"))
    feats = [jnp.zeros((1, 8, 8, 4), dtype)]
    jra.multilevel_roi_align_auto(feats, jnp.zeros((n, 5), jnp.float32), (4,), (7, 7), 56.0)
    return seen[0]


# the rungs' proposal aligns at batch 8: _fast3_r50 1536, _fast2 2048,
# _fast 4096; and one below the switch
@pytest.mark.parametrize("n", [1536, 2047, 2048, 4096])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("env", [{}, {"MONORUN_BAND_TIERED": "1"},
                                 {"MONORUN_BAND_MATMUL": "1"}])
def test_align_dispatch_matches_jax(monkeypatch, n, dtype, env):
    """JAX's band kernel and every band variant map to the port's band
    routes; the plain band and the sorted kernel both to the direct kernel
    (``csrc/roi_align.cu``, the port of both)."""
    for name in ("MONORUN_ALIGN_IMPL", "MONORUN_BAND_TIERED", "MONORUN_BAND_MATMUL",
                 "MONORUN_BAND_KROI", "MONORUN_BAND_T1_BF16"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = {"band": "kernel", "sorted": "kernel", "tiered": "tiered", "bandmm": "bandmm"}
    route = jax_route(monkeypatch, n, getattr(jnp, dtype))
    assert tra.align_choice(n, getattr(torch, dtype), True).impl == want[route]
    assert (route != "sorted") == (n >= tra.BAND_MIN_ROIS and dtype == "bfloat16")


# ---- one training step without CARAFE ---------------------------------------

def no_carafe_train_config(get_cfg):
    """``tests/test_torch_train_step.py``'s tiny lidar configuration at
    ``dense_size == roi_size`` (14): the NOC targets and losses at 14x14
    and a 196-point PnP in training."""
    cfg = tiny_train_config(get_cfg)
    r = dataclasses.replace
    d = cfg.noc_head.roi_size
    return r(cfg, noc_head=r(cfg.noc_head, dense_size=d), train=r(cfg.train, dense_size=d))


NO_CARAFE_STEP = (
    "no_carafe_train_config(tiny_train_config(kitti_multiclass_lidar_supv)), float32, "
    f"B {B}, 64x128, synthetic_train_batch(num_gt=6, num_pts=32), create_train_state("
    "PRNGKey(0), total_steps=100), _randomize(seed 0), step key PRNGKey(1), loss_ema 1.0")


def jax_no_carafe_step():
    """JAX's side of the no-CARAFE step, once per test run (``run_shared``):
    the randomized variables, the batch, the draws of the step key, and
    JAX's losses and gradients, as arrays."""
    def compute():
        H, W = 64, 128
        cfg = no_carafe_train_config(get_config)
        model, state, _ = create_train_state(cfg, jax.random.PRNGKey(0), total_steps=100,
                                             image_shape=(H, W))
        variables = _randomize({"params": state.params, "batch_stats": state.batch_stats})
        batch_np = synthetic_train_batch(cfg, B, (H, W), num_gt=6, num_pts=32)
        key = jax.random.PRNGKey(1)

        def loss_fn(params):
            (total, (metrics, _)), _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jax.tree.map(jnp.asarray, batch_np), key, 0, jnp.float32(1.0),
                method=_train_forward, mutable=["batch_stats"])
            return total, metrics

        (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, variables["params"]))
        counts = draw_counts(no_carafe_train_config(tget_config),
                             torch.from_numpy(np.array(batch_np["images"])))
        draws = jax_train_draws(cfg, key, *counts, batch_np["gt_boxes"].shape[1])
        return dict(
            variables=jax.tree.map(np.asarray, variables), batch=batch_np,
            draws=draw_arrays(draws), grads=_flat(jgrads),
            metrics={k: np.asarray(v) for k, v in dict(jmetrics, total_loss=jtotal).items()})

    return run_shared(f"test_torch_fast_presets.jax_no_carafe_step: {NO_CARAFE_STEP}",
                      compute)


@pytest.fixture(scope="module")
def step():
    """The port's no-CARAFE step on JAX's inputs beside JAX's results, each
    once per test run (``run_shared``). The step's tests are in
    ``test_torch_fast_presets_step*.py``, which xdist hands out late."""
    ref = jax_no_carafe_step()

    def compute():
        tcfg = no_carafe_train_config(tget_config)
        tmodel = MonoRUn(tcfg)
        assert tmodel.roi_head.noc_head.upsample is None
        v = ref["variables"]
        tmodel.load_state_dict(from_jax_params(v["params"], v["batch_stats"]))
        tbatch = {k: torch.from_numpy(np.array(a)) for k, a in ref["batch"].items()}
        total, (tmetrics, _) = tmodel.train_forward(tbatch, torch.tensor(1.0),
                                                    train_draws_of(ref["draws"]))
        names = [n for n, _ in tmodel.named_parameters()]
        tgrads = torch.autograd.grad(total, [p for _, p in tmodel.named_parameters()])
        tmetrics = {k: v.detach() for k, v in tmetrics.items()}
        tmetrics["total_loss"] = total.detach()
        return dict(tmetrics=tmetrics,
                    tgrads=to_jax_leaves(dict(zip(names, tgrads)), list(ref["grads"])))

    port = unpack(run_shared(f"test_torch_fast_presets.step: the port's on {NO_CARAFE_STEP}",
                             lambda: pack(compute())))
    return dict(port, jmetrics=ref["metrics"], jgrads=ref["grads"])


def check_no_carafe_loss(step, name):
    """``test_no_carafe_step_losses_match``: the port's ``name`` against JAX's."""
    got, ref = float(step["tmetrics"][name]), float(step["jmetrics"][name])
    assert np.isfinite(got)
    rtol = 1e-3 if name in AFTER_PNP else 1e-5
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(abs(ref), 1e-5))


# ---- tests/test_fast_preset.py, against the JAX package ----------------------

@pytest.mark.parametrize("name", PRESETS)
def test_preset_shapes(name):
    """``test_fast_preset.py:47-55,127-144`` on the port's presets, each
    field equal to JAX's."""
    cfg, jcfg = tget_config(name), get_config(name)
    fields = lambda c: (c.data.test_scale, c.data.pad_height, c.data.pad_width,  # noqa: E731
                        c.test.rpn_nms_pre, c.test.rpn_nms_post, c.test.head_slots,
                        c.global_head.mc_samples, c.noc_head.roi_size,
                        c.noc_head.dense_size, c.train.dense_size, c.backbone.depth)
    assert fields(cfg) == fields(jcfg)
    s = cfg.data.test_scale
    assert cfg.data.pad_height % 64 == 0 and cfg.data.pad_width % 64 == 0
    assert 376 * s <= cfg.data.pad_height and 1242 * s <= cfg.data.pad_width
    assert cfg.backbone.depth == (50 if name.endswith("_r50") else 101)
    if "fast2" in name or "fast3" in name:
        assert cfg.noc_head.dense_size == cfg.noc_head.roi_size == cfg.train.dense_size == 14
        assert cfg.global_head.mc_samples == 16
        assert MonoRUn(tiny_rung(tget_config, "fast2")).roi_head.noc_head.upsample is None
    if "fast3" in name:
        assert (s, cfg.data.pad_height, cfg.data.pad_width) == (0.625, 256, 832)
        assert (cfg.test.rpn_nms_post, cfg.test.head_slots) == (192, 16)
    elif "fast2" in name:
        assert (s, cfg.test.rpn_nms_post, cfg.test.head_slots) == (0.75, 256, 24)
    else:
        assert (s, cfg.test.rpn_nms_post, cfg.noc_head.dense_size) == (0.75, 512, 28)


@pytest.mark.parametrize("name", ["kitti_multiclass_fast", "kitti_multiclass_fast3_r50"])
def test_prepare_test_sample_scales_image_and_intrinsics(kitti_dir, name):  # noqa: F811
    """``test_fast_preset.py:57-70``: the port's sample equals JAX's."""
    from monorun_tpu.data.kitti import KITTI3DDataset as JDataset
    from monorun_tpu.data.pipeline import prepare_test_sample as jprepare
    from monorun_tpu_torch.data.kitti import KITTI3DDataset
    from monorun_tpu_torch.data.pipeline import prepare_test_sample

    cfg = tget_config(name)
    s = cfg.data.test_scale
    ds = KITTI3DDataset(kitti_dir, "val.txt", classes=cfg.data.classes)
    got = prepare_test_sample(ds, 0, cfg.data)
    ref = jprepare(JDataset(kitti_dir, "val.txt", classes=cfg.data.classes), 0,
                   get_config(name).data)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    assert got["images"].shape == (cfg.data.pad_height, cfg.data.pad_width, 3)
    assert tuple(got["img_shapes"]) == (round(375 * s), round(1242 * s))
    native = ds.get_ann(0)["cam_intrinsic"]
    np.testing.assert_allclose(got["cam"][:2], native[:2] * s, rtol=1e-6)
    np.testing.assert_allclose(got["cam"][2], native[2])
    p = np.array([2.0, 1.0, 15.0])
    uv = lambda K: (K @ p)[:2] / (K @ p)[2]  # noqa: E731
    np.testing.assert_allclose(uv(got["cam"]), uv(native) * s, rtol=1e-6)


def _stub_detections(B_, M=2):
    b3 = np.zeros((B_, M, 8), np.float32)
    b3[..., :3] = [4.0, 1.5, 1.7]
    b3[..., 4] = 1.6
    b3[..., 5] = 15.0
    b3[..., 7] = 0.8
    return dict(
        bboxes_2d=np.tile(np.array([60.0, 30.0, 105.0, 67.5], np.float32), (B_, M, 1)),
        scores_2d=np.full((B_, M), 0.8, np.float32),
        labels=np.zeros((B_, M), np.int64), bboxes_3d=b3, valid=np.ones((B_, M), bool),
        pose_cov=np.tile(np.eye(4, dtype=np.float32) * 0.1, (B_, M, 1, 1)), extras={},
    )


def test_run_eval_maps_boxes_back_to_native(kitti_dir, tmp_path):  # noqa: F811
    """``test_fast_preset.py:73-124``: a stub session returns 0.75x-space
    boxes; both packages' ``run_eval`` feed the model 0.75x shapes and
    write the same native-coordinate result files and AP dict."""
    from monorun_tpu.apis.test import run_eval as jrun_eval
    from monorun_tpu.data.kitti import KITTI3DDataset as JDataset
    from monorun_tpu_torch.apis.test import run_eval
    from monorun_tpu_torch.data.kitti import KITTI3DDataset

    name = "kitti_multiclass_fast"
    out = {}
    for pkg, Dataset, run_fn, wrap in (
            ("jax", JDataset, jrun_eval, lambda d: JDetections(**d)),
            ("port", KITTI3DDataset, run_eval, lambda d: Detections(
                **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                   for k, v in d.items()}))):
        cfg = (get_config if pkg == "jax" else tget_config)(name)
        captured = {}

        class StubSession:
            pass

        session = StubSession()
        session.cfg = cfg

        def run(images, cam, shapes, seed=0, captured=captured, wrap=wrap):
            captured["shapes"] = np.asarray(shapes)
            return wrap(_stub_detections(images.shape[0]))

        session.run = run
        ds = Dataset(kitti_dir, "val.txt", classes=cfg.data.classes, with_labels=True)
        result_dir = tmp_path / pkg
        ap = run_fn(session, ds, batch_size=2, print_summary=False, progress=False,
                    result_dir=str(result_dir))
        np.testing.assert_allclose(captured["shapes"][0],
                                   [round(375 * 0.75), round(1242 * 0.75)])
        line = (result_dir / "000000.txt").read_text().splitlines()[0].split()
        np.testing.assert_allclose(np.asarray(line[4:8], np.float32),
                                   [80.0, 40.0, 140.0, 90.0], atol=1e-3)
        out[pkg] = (ap, sorted((p.name, p.read_text()) for p in result_dir.iterdir()))
    assert out["port"] == out["jax"]


# ---- ResNet-50 weights -----------------------------------------------------------
