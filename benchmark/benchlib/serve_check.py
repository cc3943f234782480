"""``correct`` for a served cell: the program's answers to a sample of
the window's requests, judged by the plain reference (``monorun_ref``,
float32, TF32 off) on the same canvases, weights and draws.

A detector's answer is a set of slots picked by top-k and NMS, which a
change of rounding reorders, so two readings are taken:

* the 2D stage (preprocess, backbone, RPN and proposals, bbox head and
  its NMS): each image's sorted 2D scores against the reference's own
  forward (a reordering leaves the sorted values in place);
* the heads from the head slots on (global head with its MC samples,
  NOC head, PnP, score head, 3D NMS): the reference follows the
  program's own served 2D detections (``slot_heads``) and recomputes
  every 3D output from them; the program's 3D sizes, locations, yaws,
  3D scores and covariances are held to it slot by slot, each by a
  quantile of the slots' errors (``judge``); and the boxes the program
  keeps, to the 3D NMS's own threshold.

The control (``control.py``) is the reference in the program's place,
one step of precision below the configuration's."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

NEG = -1e29          # scores_2d of an empty slot are the program's NEG_INF (-1e30)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


def reference_model(ref_cfg_cls, model_cls, cfg_dict, seed: int, device,
                    stated: bool = False):
    """The reference with the seed's weights: in float32 (TF32 off), or
    with ``stated`` in the configuration's own compute dtype (the
    control's base)."""
    from .weights import build

    cfg = build_ref_config(ref_cfg_cls, cfg_dict, stated)
    return build(model_cls, cfg, seed, device).eval()


def build_ref_config(ref_cfg_cls, cfg_dict, stated: bool = False):
    from .spec import build_config

    d = dict(cfg_dict)
    if not stated:
        d["compute_dtype"] = "float32"
    return build_config(ref_cfg_cls, d)


def reference_answers(model, request, masks, keys, served=None) -> Dict[str, np.ndarray]:
    """The reference's own forward on a request (``own``), and, given the
    program's served fields, its heads on the program's 2D detections."""
    from monorun_ref.data.pipeline import device_preprocess, scale_intrinsics
    from monorun_ref.models.detector import HeadDraws

    dev = next(model.parameters()).device
    cfg = model.cfg
    raw, cam, shapes = (torch.as_tensor(x).to(dev) for x in request)
    draws = HeadDraws(tuple(m.float() for m in masks), keys)
    out = {}
    with torch.no_grad():
        images, img_shapes = device_preprocess(raw, shapes.float(), cfg.data)
        cam = scale_intrinsics(cam.float(), cfg.data.test_scale)
        feats = model.extract_feats(images)
        pad = (cfg.data.pad_height, cfg.data.pad_width)
        det = model.heads_forward(feats, cam, img_shapes, pad, draws)
        out["own"] = {k: _np(v) for k, v in det._asdict().items() if k != "extras"}
        if served is not None:
            t = {k: torch.as_tensor(served[k]).to(dev)
                 for k in ("bboxes_2d", "scores_2d", "labels")}
            valid2d = t["scores_2d"] > NEG
            forced = model.slot_heads(feats, cam, img_shapes, t["bboxes_2d"].float(),
                                      t["scores_2d"].float(), t["labels"].long(), valid2d, draws)
            out.update({f"forced_{k}": _np(getattr(forced, k))
                        for k in ("bboxes_3d", "valid", "pose_cov")})
            out["forced_sizes"] = _np(forced.extras["sizes"])
    return out


def dim_codes(sizes: np.ndarray, labels: np.ndarray, cfg: Dict) -> np.ndarray:
    """The slots' 3D sizes (l, h, w) back in the global head's output
    space (``coders.py:DimCoder``: (size - class mean) / class std)."""
    gh = cfg["global_head"]
    means = np.asarray(gh["dim_means"], np.float64)
    stds = np.asarray(gh["dim_stds"], np.float64)
    k = np.clip(labels, 0, len(means) - 1)
    return (sizes[..., :3] - means[k]) / stds[k]


def _wrapped(a: np.ndarray) -> np.ndarray:
    return np.abs((a + np.pi) % (2 * np.pi) - np.pi)


def slot_errors(x: Dict[str, np.ndarray], r: Dict[str, np.ndarray], both: np.ndarray
                ) -> Dict[str, np.ndarray]:
    """Per slot of ``both``, how far ``x``'s PnP pose, 3D score and pose
    covariance lie from ``r``'s: the location relative to its distance
    (at least 1 m), the yaw in radians, the final 3D score, and the
    covariance relative to its Frobenius norm."""
    b, c = x["bboxes_3d"][both], r["bboxes_3d"][both]
    C = x["pose_cov"][both].reshape(-1, 16)
    D = r["pose_cov"][both].reshape(-1, 16)
    dist = np.maximum(np.linalg.norm(c[:, 3:6], axis=1), 1.0)
    return dict(
        loc=np.linalg.norm(b[:, 3:6] - c[:, 3:6], axis=1) / dist,
        yaw=_wrapped(b[:, 6] - c[:, 6]),
        score3d=np.abs(b[:, 7] - c[:, 7]),
        cov=np.linalg.norm(C - D, axis=1) / np.maximum(np.linalg.norm(D, axis=1), 1e-30),
    )


def sorted_scores(scores_2d: np.ndarray) -> np.ndarray:
    """Each image's 2D scores, largest first, an empty slot as 0."""
    return -np.sort(-np.maximum(scores_2d, 0.0), axis=1)


def nms3d_overlap(served: Dict[str, np.ndarray], slots: int, device) -> float:
    """The largest bird's-eye IoU between two boxes of one class that the
    program serves as valid in one image: the 3D NMS keeps none above
    the configuration's ``test.nms_3d_thr``. Worked out as the 3D NMS
    works it out, on its device, so that a pair kept just under the
    threshold is not read just over it."""
    from monorun_ref.ops.rotated_iou import rotated_iou

    worst_iou = 0.0
    for valid, boxes, labels in zip(served["valid"][:, :slots], served["bboxes_3d"][:, :slots],
                                    served["labels"][:, :slots]):
        lab = labels[valid]
        same = (lab[:, None] == lab[None, :]) & ~np.eye(len(lab), dtype=bool)
        if not same.any():
            continue
        bev = torch.as_tensor(boxes[valid][:, [3, 5, 0, 2, 6]], dtype=torch.float32,
                              device=device)
        # the 3D NMS's own coordinates: each class moved 1e4 m apart
        off = torch.as_tensor(lab, dtype=torch.float32, device=device)[:, None] * 1e4
        bev = torch.cat([bev[:, :2] + off, bev[:, 2:]], 1)
        worst_iou = max(worst_iou, float(rotated_iou(bev, bev).cpu().numpy()[same].max()))
    return worst_iou


def _ratio(num: float, den: float) -> float:
    return float(num / max(den, 1e-12))


def judge(served: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
          ref16: Dict[str, np.ndarray], slots: int, cfg: Dict, device) -> Dict[str, float]:
    """The numbers compared, for one request. But for ``nms3d_overlap``,
    each is the program's error against the float32 reference over the
    same error of the bfloat16 reference (``ref16``), since how far the
    format itself strays differs from seed to seed.

    * ``score2d_err_ratio``, the 2D stage (preprocess, backbone, RPN and
      proposals, bbox head and its NMS): the mean gap between each image's
      sorted 2D scores and the reference's own forward's (a reordering
      leaves the sorted values in place).
    * The heads from the head slots on: the references follow the
      program's own served 2D detections (``slot_heads``).
      ``size_err_ratio`` (global head): the third quartile of the 3D
      sizes' error in the head's output space (``dim_codes``), relative
      to the output's size, over the slots the program serves as valid.
      ``loc_med_ratio``, ``yaw_med_ratio`` (NOC head and PnP),
      ``cov_med_ratio`` (PnP) and ``score3d_med_ratio`` (score head): the
      median of ``slot_errors`` over the slots both the program and the
      float32 reference keep. A quantile, not the worst slot: with random
      weights a slot's RANSAC can jump with a rounding.
    * ``nms3d_overlap`` (3D NMS): the largest overlap of two kept boxes
      (``nms3d_overlap``), held to the configuration's own threshold.

    ``slots_compared``: how many slots the pose numbers had (not a
    limit)."""
    K = slots
    cut = {k: v[:, :K] for k, v in served.items()}
    f32 = {k[7:]: v[:, :K] for k, v in ref.items() if k.startswith("forced_")}
    f16 = {k[7:]: v[:, :K] for k, v in ref16.items() if k.startswith("forced_")}
    out: Dict[str, float] = {}
    gap32 = np.abs(sorted_scores(served["scores_2d"]) - sorted_scores(ref["own"]["scores_2d"]))
    gap16 = np.abs(sorted_scores(ref16["own"]["scores_2d"])
                   - sorted_scores(ref["own"]["scores_2d"]))
    out["score2d_err_ratio"] = _ratio(gap32.mean(), gap16.mean())
    out["nms3d_overlap"] = nms3d_overlap(served, K, device)

    valid = cut["valid"]
    lab = cut["labels"][valid]
    if valid.any():
        c32 = dim_codes(f32["sizes"][valid], lab, cfg)

        def size_err(sizes):
            c = dim_codes(sizes, lab, cfg)
            return np.percentile((np.abs(c - c32) / np.maximum(np.abs(c32), 1.0)).max(1), 75)

        out["size_err_ratio"] = _ratio(size_err(cut["bboxes_3d"][valid][:, :3]),
                                       size_err(f16["sizes"][valid]))
    both = valid & f32["valid"]
    both16 = f16["valid"] & f32["valid"]
    out["slots_compared"] = float(both.sum())
    if both.any() and both16.any():
        e, e16 = slot_errors(cut, f32, both), slot_errors(f16, f32, both16)
        for k in e:
            out[f"{k}_med_ratio"] = _ratio(np.median(e[k]), np.median(e16[k]))
    return out


NUMBERS = ("score2d_err_ratio", "size_err_ratio", "loc_med_ratio", "yaw_med_ratio",
           "cov_med_ratio", "score3d_med_ratio", "nms3d_overlap")


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the checked requests that have
    it (a number no request has reads infinite: nothing to compare is
    no pass), and the slots compared in all."""
    out = {}
    for k in NUMBERS:
        got = [r[k] for r in readings if k in r]
        out[k] = max(got) if got else math.inf
    out["slots_compared"] = float(sum(r["slots_compared"] for r in readings))
    return out
