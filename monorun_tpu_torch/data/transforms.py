"""Geometric augmentations: resize and crop family (host-side numpy).

Re-implements the reference's Resize3D / Crop3D / RandomCrop3D /
MinIoURandomCrop3D (datasets/pipelines/transforms.py). The shipped
configs only use flip + photometric + pad, but the full transform surface
is provided for custom training recipes.

Geometry convention (same as flip): all 3D quantities stay in the
ORIGINAL camera frame. The device-side pipeline reconstructs
original-frame pixel coordinates analytically from the augmented RoI grid
using per-image (scale_factor, flip, crop_offset) records — the augmented
images never carry a dense coord_2d field.

A 2D box is moved to the ignore list when cropping truncates it beyond
``trunc_ignore_thres`` of its area (transforms.py:111-138 semantics).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import cv2
import numpy as np


def resize_sample(
    sample: Dict[str, np.ndarray], scale: Tuple[float, float]
) -> Dict[str, np.ndarray]:
    """Resize image + 2D boxes + sparse points by (sh, sw).

    3D boxes, camera intrinsics and object coordinates are untouched;
    ``scale_factor`` accumulates so the device pipeline can map augmented
    pixels back to original-frame coordinates.
    """
    sh, sw = scale
    img = sample["image"]
    h, w = img.shape[:2]
    out = dict(sample)
    out["image"] = cv2.resize(
        img, (int(round(w * sw)), int(round(h * sh))),
        interpolation=cv2.INTER_LINEAR if sh * sw >= 1 else cv2.INTER_AREA,
    )
    scale4 = np.asarray([sw, sh, sw, sh], np.float32)
    if len(sample.get("gt_boxes", [])):
        out["gt_boxes"] = sample["gt_boxes"] * scale4
    if len(sample.get("ignore_boxes", [])):
        out["ignore_boxes"] = sample["ignore_boxes"] * scale4
    if "uv" in sample and sample["uv"].size:
        out["uv"] = sample["uv"] * np.asarray([sw, sh], np.float32)
    out["scale_factor"] = sample.get(
        "scale_factor", np.ones(2, np.float32)
    ) * np.asarray([sh, sw], np.float32)
    return out


def crop_sample(
    sample: Dict[str, np.ndarray],
    crop_box: Tuple[int, int, int, int],   # x1, y1, x2, y2 (augmented px)
    trunc_ignore_thres: float = -1.0,
) -> Optional[Dict[str, np.ndarray]]:
    """Crop image + boxes + points; truncation-aware ignore handling.

    Returns None when no GT box center survives the crop (caller retries).
    """
    x1, y1, x2, y2 = [int(v) for v in crop_box]
    out = dict(sample)
    out["image"] = sample["image"][y1:y2, x1:x2]
    off = np.asarray([x1, y1, x1, y1], np.float32)

    boxes = sample.get("gt_boxes", np.zeros((0, 4), np.float32))
    if len(boxes):
        shifted = boxes - off
        clipped = shifted.copy()
        clipped[:, [0, 2]] = np.clip(clipped[:, [0, 2]], 0, x2 - x1)
        clipped[:, [1, 3]] = np.clip(clipped[:, [1, 3]], 0, y2 - y1)
        area = np.clip(shifted[:, 2] - shifted[:, 0], 0, None) * np.clip(
            shifted[:, 3] - shifted[:, 1], 0, None
        )
        area_c = np.clip(clipped[:, 2] - clipped[:, 0], 0, None) * np.clip(
            clipped[:, 3] - clipped[:, 1], 0, None
        )
        keep_frac = area_c / np.clip(area, 1e-6, None)
        alive = area_c > 1.0
        if not alive.any():
            return None
        # heavily truncated boxes become ignore regions instead of labels
        if trunc_ignore_thres > 0:
            to_ignore = alive & (keep_frac < trunc_ignore_thres)
        else:
            to_ignore = np.zeros_like(alive)
        keep = alive & ~to_ignore
        if not keep.any():
            return None
        out["gt_boxes"] = clipped[keep]
        out["gt_labels"] = sample["gt_labels"][keep]
        out["gt_bboxes_3d"] = sample["gt_bboxes_3d"][keep]
        extra_ignores = clipped[to_ignore]
        if "uv" in sample and sample["uv"].size:
            out["uv"] = (sample["uv"] - np.asarray([x1, y1], np.float32))[
                keep
            ]
            out["pts_valid"] = sample["pts_valid"][keep]
            inside = (
                (out["uv"][..., 0] >= 0)
                & (out["uv"][..., 0] < x2 - x1)
                & (out["uv"][..., 1] >= 0)
                & (out["uv"][..., 1] < y2 - y1)
            )
            out["pts_valid"] = out["pts_valid"] & inside
            out["oc"] = sample["oc"][keep]
    else:
        extra_ignores = np.zeros((0, 4), np.float32)

    ig = sample.get("ignore_boxes", np.zeros((0, 4), np.float32))
    if len(ig):
        ig = ig - off
        ig[:, [0, 2]] = np.clip(ig[:, [0, 2]], 0, x2 - x1)
        ig[:, [1, 3]] = np.clip(ig[:, [1, 3]], 0, y2 - y1)
        w_ok = (ig[:, 2] - ig[:, 0] > 1) & (ig[:, 3] - ig[:, 1] > 1)
        ig = ig[w_ok]
    out["ignore_boxes"] = np.concatenate([ig, extra_ignores], axis=0)
    out["crop_offset"] = sample.get(
        "crop_offset", np.zeros(2, np.float32)
    ) + np.asarray([x1, y1], np.float32)
    return out


def random_crop(
    sample: Dict[str, np.ndarray],
    crop_size: Tuple[int, int],
    rng: np.random.Generator,
    trunc_ignore_thres: float = 0.3,
    max_tries: int = 8,
) -> Dict[str, np.ndarray]:
    """RandomCrop3D: uniform crop window, retried until a GT survives."""
    h, w = sample["image"].shape[:2]
    ch = min(crop_size[0], h)
    cw = min(crop_size[1], w)
    for _ in range(max_tries):
        y1 = int(rng.integers(0, h - ch + 1))
        x1 = int(rng.integers(0, w - cw + 1))
        out = crop_sample(
            sample, (x1, y1, x1 + cw, y1 + ch), trunc_ignore_thres
        )
        if out is not None:
            return out
    return sample


def min_iou_random_crop(
    sample: Dict[str, np.ndarray],
    rng: np.random.Generator,
    min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
    min_crop_size: float = 0.3,
    trunc_ignore_thres: float = 0.3,
    max_tries: int = 32,
) -> Dict[str, np.ndarray]:
    """MinIoURandomCrop3D: sample a crop whose IoU with every kept GT box
    exceeds a randomly chosen threshold (SSD-style)."""
    boxes = sample.get("gt_boxes", np.zeros((0, 4), np.float32))
    if not len(boxes):
        return sample
    h, w = sample["image"].shape[:2]
    mode = rng.choice(len(min_ious) + 1)
    if mode == len(min_ious):
        return sample
    min_iou = min_ious[mode]
    for _ in range(max_tries):
        cw = rng.uniform(min_crop_size * w, w)
        ch = rng.uniform(min_crop_size * h, h)
        if cw / ch < 0.5 or cw / ch > 2:
            continue
        x1 = rng.uniform(0, w - cw)
        y1 = rng.uniform(0, h - ch)
        patch = np.asarray([x1, y1, x1 + cw, y1 + ch], np.float32)
        lt = np.maximum(boxes[:, :2], patch[:2])
        rb = np.minimum(boxes[:, 2:], patch[2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        patch_area = cw * ch
        iou = inter / np.clip(area + patch_area - inter, 1e-6, None)
        if (iou >= min_iou).any():
            out = crop_sample(
                sample,
                (int(x1), int(y1), int(x1 + cw), int(y1 + ch)),
                trunc_ignore_thres,
            )
            if out is not None:
                return out
    return sample
