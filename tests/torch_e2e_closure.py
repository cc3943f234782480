"""Train, serve, score: the port's counterpart of ``tests/test_e2e_synthetic.py``.

Shared by ``chip_smoke.py`` (phase 18) and ``tests/test_torch_e2e_closure.py``
(its card test). It imports neither JAX nor the JAX package, so it runs on
a machine that has neither.

A nano ``kitti_car_lidar_supv`` model (the JAX file's ``nano_config``)
memorises 12 geometrically consistent synthetic scenes
(``utils/synthetic.py:synthetic_scene_batch``: the image texture is the NOC
encoding, the sparse supervision is pinhole-exact) through the port's
``create_train_state`` and ``train_step``; the trained weights then go
through ``InferenceSession`` (RPN, R-CNN, MC global head, NOC, PnP, score,
3D NMS) and the port's KITTI evaluator. JAX's bars, unchanged:

- no non-finite gradient leaf over the trajectory (``:119``);
- ``mean_iou`` over the last 8 steps above 0.3 (``:128``);
- Car moderate bbox@0.70 above 45, 3d@0.50 and bev@0.50 above 33
  (``:227-240``), also with the proposal cut to 24 (``:343``);
- head slots at 4: bbox within 1 AP of the all-slot run, 3d and bev
  within 8 AP and above 33 (``:243``);
- a crowded scene served with 3 head slots: the 2D outputs untouched,
  nothing valid and no 3D box past slot 3, and the 3 slots the best by 2D
  score (``:274``);
- the scenes rendered at 4/3 and served at 0.75x: bbox above 12, 3d and
  bev above 15 (``:363``);
- a second training at ``dense_size`` 14 with 4 head slots (the fast2
  rung's cut): ``mean_iou`` above 0.25, bbox above 40, 3d above 5, bev
  above 12 (``:396-451``).

Where JAX splits a ``PRNGKey(5000 + i)`` for step i, the port seeds a
generator on the device with ``5000 + i`` (``7000 + i`` for the fast2
training); the weights come from ``create_train_state``'s seed (0, and 2
for fast2), and every served batch from ``seed=9``, as in JAX. The run
takes torch's deterministic algorithms (``deterministic``), so that, like
JAX's run on a CPU, it repeats: on a GPU, cuBLAS then needs
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts (``CUBLAS_CONFIG``; the
callers set it when they are imported).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from monorun_tpu_torch.apis.inference import InferenceSession, detections_to_host
from monorun_tpu_torch.config import get_config
from monorun_tpu_torch.eval.kitti_eval import kitti_eval
from monorun_tpu_torch.models.detector import MonoRUn
from monorun_tpu_torch.train import create_train_state, train_step
from monorun_tpu_torch.utils.synthetic import synthetic_scene_batch

HW = (96, 192)
N_STEPS = 420
B = 2
N_SCENES = 6          # 6 batches x 2 images = 12 scenes, 24 GT: R40 AP tops out at 60
EARLY_STOP_FROM = 240
EARLY_STOP_IOU = 0.55  # mean_iou over the last 12 steps
CROWD_HW = (96, 384)
CROWD_SLOTS = 3
SERVE_SEED = 9
CUBLAS_CONFIG = ("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
MOD = "Car_{}_moderate"
BBOX, BEV, D3 = MOD.format("bbox_0.70"), MOD.format("bev_0.50"), MOD.format("3d_0.50")


def nano_config(compute_dtype: str = "float32"):
    """``tests/test_e2e_synthetic.py:nano_config`` from the port's presets:
    ``kitti_car_lidar_supv`` with a ResNet-26, a 64-channel neck, narrow
    FCs, 4 MC samples, 8 RANSAC hypotheses and 5 LM iterations, and the
    sharp sampling caps (3 and 2) that keep the memorised textures."""
    cfg = get_config("kitti_car_lidar_supv")
    r = dataclasses.replace
    return r(
        cfg,
        compute_dtype=compute_dtype,
        backbone=r(cfg.backbone, depth=26),
        neck=r(cfg.neck, out_channels=64),
        rpn=r(cfg.rpn, nms_pre=48, nms_post=48, train_nms_pre=48, feat_channels=64),
        bbox_head=r(cfg.bbox_head, in_channels=64, fc_out_channels=256, align_max_ratio=3),
        global_head=r(cfg.global_head, in_channels=64, fc_out_channels=256, mc_samples=4),
        noc_head=r(cfg.noc_head, in_channels=64, conv_out_channels=64,
                   carafe_compressed_channels=16, align_max_ratio=2),
        score_head=r(cfg.score_head, reg_fc_out_channels=256, pose_fc_out_channels=256,
                     fc_out_channels=64),
        pose_head=r(cfg.pose_head, ransac_hypotheses=8, lm_iters=5),
        train=r(cfg.train, rcnn_num_samples=32, max_pos=8, rpn_num_samples=64, lr=1.0e-3,
                warmup_iters=40, grad_clip_norm=35.0),
        test=r(cfg.test, rpn_nms_pre=48, rpn_nms_post=48, max_per_img=8),
    )


def fast2_config(cfg):
    """The fast2 rung's structural cut on the nano model: 14x14 dense maps
    (no CARAFE, a 196-point PnP) and head slots at half the detection
    slots."""
    r = dataclasses.replace
    return r(cfg, noc_head=r(cfg.noc_head, dense_size=14),
             train=r(cfg.train, dense_size=14), test=r(cfg.test, head_slots=4))


def with_test(cfg, **test):
    return dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, **test))


def scene_batches(cfg, hw=HW) -> List[Dict[str, np.ndarray]]:
    """The 6 training batches (seeds 40-45), rendered at ``hw``."""
    return [synthetic_scene_batch(cfg, B, hw, num_gt=4, num_pts=256, seed=40 + i,
                                  n_objects=2) for i in range(N_SCENES)]


def crowd_batch(cfg) -> Dict[str, np.ndarray]:
    """Up to 6 objects an image at training depth on a wider canvas."""
    return synthetic_scene_batch(cfg, B, CROWD_HW, num_gt=8, num_pts=64, seed=77,
                                 n_objects=6, z_range=(4.5, 7.0), u_span=(0.08, 0.92))


class Trained(NamedTuple):
    cfg: object
    model: MonoRUn
    hist: Dict[str, List[float]]
    steps: int
    seconds: float


def train(cfg, device, seed: int, key_base: int, steps: int = N_STEPS) -> Trained:
    """Up to ``steps`` steps over the scene batches in turn, stopping early
    once ``mean_iou`` over the last 12 steps passes 0.55 after step 240.
    Every step's draws come from a generator on ``device`` seeded with
    ``key_base + i``."""
    model, state, opt = create_train_state(cfg, total_steps=N_STEPS, device=device,
                                           seed=seed)
    device = next(model.parameters()).device
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in scene_batches(cfg)]
    hist: Dict[str, List[float]] = {}
    t0 = time.perf_counter()
    for i in range(steps):
        gen = torch.Generator(device=device).manual_seed(key_base + i)
        state, metrics = train_step(model, opt, state, batches[i % N_SCENES], generator=gen)
        for k in ("total_loss", "mean_iou", "nonfinite_grad_leaves", "loss_calib",
                  "loss_score"):
            hist.setdefault(k, []).append(float(metrics[k]))
        if i >= EARLY_STOP_FROM and np.mean(hist["mean_iou"][-12:]) > EARLY_STOP_IOU:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Trained(cfg, model, hist, i + 1, time.perf_counter() - t0)


def session(cfg, trained: Trained) -> InferenceSession:
    """The trained weights in a fresh model built with ``cfg`` (the test
    options differ), served on the device they were trained on."""
    model = MonoRUn(cfg)
    model.load_state_dict(copy.deepcopy(trained.model.state_dict()))
    return InferenceSession(cfg, model, B, next(trained.model.parameters()).device)


def scale_batch(b, s):
    """The fast presets' downscale: image and intrinsics scaled together
    inside the same padded canvas; the GT stays native (the detections'
    2D boxes are mapped back by 1/s)."""
    import cv2

    imgs = np.asarray(b["images"])
    out = np.zeros_like(imgs)
    for i in range(imgs.shape[0]):
        h, w = [int(v) for v in b["img_shapes"][i]]
        small = cv2.resize(imgs[i, :h, :w], (int(round(w * s)), int(round(h * s))),
                           interpolation=cv2.INTER_LINEAR)
        out[i, :small.shape[0], :small.shape[1]] = small
    cam = np.asarray(b["cam"]).copy()
    cam[:, :2] *= s
    return dict(b, images=out, cam=cam, img_shapes=np.asarray(b["img_shapes"]) * s)


def serve(sess: InferenceSession, b) -> Dict[str, np.ndarray]:
    det, _ = detections_to_host(sess.run(b["images"], b["cam"], b["img_shapes"],
                                         seed=SERVE_SEED))
    return det


def eval_trained(cfg, trained: Trained, batches, scale: float = 1.0
                 ) -> Tuple[str, Dict[str, float]]:
    """Every scene served and scored by the KITTI evaluator (R40):
    ``tests/test_e2e_synthetic.py:_eval_trained``."""
    sess = session(cfg, trained)
    gt_annos, det_annos = [], []
    for b in batches:
        if scale != 1.0:
            b = scale_batch(b, scale)
        det = serve(sess, b)
        for i in range(B):
            ok = b["gt_valid"][i]
            g3d = b["gt_bboxes_3d"][i][ok]
            loc = g3d[:, 3:6]
            gt_annos.append(dict(
                name=np.asarray(["Car"] * len(g3d)), truncated=np.zeros(len(g3d)),
                occluded=np.zeros(len(g3d), np.int32),
                alpha=g3d[:, 6] - np.arctan2(loc[:, 0], loc[:, 2]),
                bbox=b["gt_boxes"][i][ok], dimensions=g3d[:, :3], location=loc,
                rotation_y=g3d[:, 6], score=np.zeros(len(g3d))))
            keep = det["valid"][i]
            b3d = det["bboxes_3d"][i][keep]
            b2d = det["bboxes_2d"][i][keep] / scale
            order = np.argsort(-b3d[:, 7])
            b3d, b2d = b3d[order], b2d[order]
            dloc = b3d[:, 3:6]
            det_annos.append(dict(
                name=np.asarray(["Car"] * len(b3d)),
                truncated=np.full(len(b3d), -1, np.int8),
                occluded=np.full(len(b3d), -1, np.int8),
                alpha=b3d[:, 6] - np.arctan2(dloc[:, 0], dloc[:, 2]), bbox=b2d,
                dimensions=b3d[:, :3], location=dloc, rotation_y=b3d[:, 6],
                score=b3d[:, 7]))
    return kitti_eval(gt_annos, det_annos, ("Car",), eval_types=("bbox", "bev", "3d"))


def crowd_check(trained: Trained) -> Dict[str, object]:
    """``test_head_slot_truncation_on_crowded_scene``: the crowded scene
    served with every slot and with ``CROWD_SLOTS``; its checks by name."""
    cfg, K = trained.cfg, CROWD_SLOTS
    crowd = crowd_batch(cfg)
    det_all = serve(session(with_test(cfg, head_slots=0), trained), crowd)
    det_k = serve(session(with_test(cfg, head_slots=K), trained), crowd)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), det_k["pose_cov"][:, K:].shape)
    n_all = det_all["valid"].sum(1)
    return dict(
        objects=crowd["gt_valid"].sum(1).tolist(), valid_all=n_all.tolist(),
        checks={
            "the crowd scene holds at least 5 objects": int(crowd["gt_valid"].sum(1).max()) >= 5,
            "the all-slot run finds more than K detections": bool((n_all > K).any()),
            "2D boxes and scores are untouched by the head slots": bool(
                np.allclose(det_k["bboxes_2d"], det_all["bboxes_2d"], rtol=1e-7, atol=0)
                and np.allclose(det_k["scores_2d"], det_all["scores_2d"], rtol=1e-7, atol=0)),
            "nothing is valid past slot K": not det_k["valid"][:, K:].any(),
            "no 3D box past slot K": not det_k["bboxes_3d"][:, K:].any(),
            "identity covariances past slot K": bool(np.array_equal(
                det_k["pose_cov"][:, K:], eye)),
            "the slots are sorted by 2D score": bool(
                (np.diff(det_all["scores_2d"], axis=1) <= 1e-6).all()),
            "a real detection was dropped": int(det_all["valid"][:, K:].sum()) > 0,
        })


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms inside: deterministic cuDNN and
    cuBLAS kernels and scatters (the direct align kernels have no
    atomics), so that two runs of the closure give the same weights."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def moderate(ap: Dict[str, float]) -> Dict[str, float]:
    return {k: round(float(v), 2) for k, v in ap.items() if "moderate" in k}


def run_closure(device, compute_dtype: str = "float32", guards: bool = True,
                record=None) -> Dict[str, object]:
    """The closure on ``device``: the base training and its evaluation; with
    ``guards`` the head-slot, crowd, proposal-cut and resolution guards on
    it and the fast2 training. ``record`` wraps the base training (a
    context manager, e.g. one that records its first step's aligns).
    Returns APs, steps and seconds; ``bars`` says which bar each met."""
    with deterministic():
        return _run_closure(device, compute_dtype, guards, record)


def _run_closure(device, compute_dtype, guards, record):
    cfg = nano_config(compute_dtype)
    with (record or contextlib.nullcontext)():
        base = train(cfg, device, seed=0, key_base=5000)
    batches = scene_batches(cfg)
    t0 = time.perf_counter()
    summary, ap = eval_trained(cfg, base, batches)
    out = dict(compute_dtype=compute_dtype, base=dict(
        steps=base.steps, train_s=base.seconds, eval_s=time.perf_counter() - t0,
        ap=moderate(ap), last_mean_iou=float(np.mean(base.hist["mean_iou"][-8:])),
        max_nonfinite=max(base.hist["nonfinite_grad_leaves"]),
        finite_loss=bool(np.isfinite(base.hist["total_loss"]).all()),
        loss_score_nonzero_steps=int(np.count_nonzero(base.hist["loss_score"])),
        loss_calib_nonzero_steps=int(np.count_nonzero(base.hist["loss_calib"]))),
        summary=summary)
    if not guards:
        return out
    out["head_slots"] = moderate(eval_trained(with_test(cfg, head_slots=4), base,
                                              batches)[1])
    out["crowd"] = crowd_check(base)
    out["proposal_cut"] = moderate(eval_trained(
        with_test(cfg, rpn_nms_pre=24, rpn_nms_post=24), base, batches)[1])
    big = scene_batches(cfg, (HW[0] * 4 // 3, HW[1] * 4 // 3))
    out["resolution"] = moderate(eval_trained(cfg, base, big, scale=0.75)[1])
    del base
    f2 = train(fast2_config(cfg), device, seed=2, key_base=7000)
    t0 = time.perf_counter()
    out["fast2"] = dict(
        steps=f2.steps, train_s=f2.seconds,
        ap=moderate(eval_trained(f2.cfg, f2, batches)[1]),
        eval_s=time.perf_counter() - t0,
        last_mean_iou=float(np.mean(f2.hist["mean_iou"][-8:])),
        max_nonfinite=max(f2.hist["nonfinite_grad_leaves"]))
    return out


def bars(out) -> Dict[str, bool]:
    """Each of JAX's bars by name: met or not. Without the guards (the
    bf16 reading) only finiteness and ``mean_iou``."""
    b = out["base"]
    got = {
        "no non-finite gradient leaf": b["max_nonfinite"] == 0 and b["finite_loss"],
        "mean_iou over the last 8 steps > 0.3": b["last_mean_iou"] > 0.3,
    }
    if "fast2" not in out:
        return got
    ap, slots = b["ap"], out["head_slots"]
    got.update({
        "bbox@0.70 > 45": ap[BBOX] > 45.0, "3d@0.50 > 33": ap[D3] > 33.0,
        "bev@0.50 > 33": ap[BEV] > 33.0,
        "head slots 4: bbox within 1 AP": abs(slots[BBOX] - ap[BBOX]) <= 1.0,
        "head slots 4: 3d and bev within 8 AP and > 33": all(
            abs(slots[k] - ap[k]) <= 8.0 and slots[k] > 33.0 for k in (D3, BEV)),
        "proposal cut: bbox > 45, 3d and bev > 33": (
            out["proposal_cut"][BBOX] > 45.0 and out["proposal_cut"][D3] > 33.0
            and out["proposal_cut"][BEV] > 33.0),
        "0.75x resolution: bbox > 12, 3d and bev > 15": (
            out["resolution"][BBOX] > 12.0 and out["resolution"][D3] > 15.0
            and out["resolution"][BEV] > 15.0),
        "fast2: no non-finite gradient leaf": out["fast2"]["max_nonfinite"] == 0,
        "fast2: mean_iou over the last 8 steps > 0.25": out["fast2"]["last_mean_iou"] > 0.25,
        "fast2: bbox > 40, 3d > 5, bev > 12": (
            out["fast2"]["ap"][BBOX] > 40.0 and out["fast2"]["ap"][D3] > 5.0
            and out["fast2"]["ap"][BEV] > 12.0),
    })
    got.update({f"crowd: {k}": v for k, v in out["crowd"]["checks"].items()})
    return got
