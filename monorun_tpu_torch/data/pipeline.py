"""Host-side augmentation and static batch assembly, and on-device
test-time preprocessing: the PyTorch counterpart of
``monorun_tpu/data/pipeline.py``.

The host half (``photometric_distortion``, ``load_image``,
``normalize_pad``, ``prepare_train_sample``, ``prepare_test_sample``,
``collate``) is a copy of the JAX package's numpy code. It mirrors the
reference train/test pipelines (configs/kitti_multiclass.py:216-252):
load -> [flip, photometric] -> normalize -> pad -> collect, into
*fixed-shape* batches (padded GT slots, sparse LiDAR point caps).

Geometry convention under horizontal flip (transforms.py:36-51): only the
image, 2D boxes, and sparse point pixel positions are mirrored; all 3D
quantities stay in the original camera frame.

The device half (``device_preprocess``, ``scale_intrinsics``) serves
uint8 canvases on the session's device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from ..config import DataConfig
from .kitti import KITTI3DDataset

Tensor = torch.Tensor


def photometric_distortion(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness_delta: float = 32.0,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: float = 18.0,
) -> np.ndarray:
    """mmdet PhotoMetricDistortion with default parameters (float32 RGB)."""
    img = img.astype(np.float32)
    if rng.integers(2):
        img = img + rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.integers(2)
    if mode == 1 and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    # saturation / hue in HSV space
    if rng.integers(2) or rng.integers(2):
        hsv = cv2.cvtColor(
            np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV
        ).astype(np.float32)
        if rng.integers(2):
            hsv[..., 1] = np.clip(
                hsv[..., 1] * rng.uniform(*saturation_range), 0, 255
            )
        if rng.integers(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)) % 180
        img = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(
            np.float32
        )
    if mode == 0 and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    if rng.integers(2):
        img = img[..., rng.permutation(3)]
    return img


def load_image(path: str, to_rgb: bool = True) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    if to_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img.astype(np.float32)


def normalize_pad(
    img: np.ndarray, data_cfg: DataConfig
) -> Tuple[np.ndarray, Tuple[int, int]]:
    h, w = img.shape[:2]
    img = (img - np.asarray(data_cfg.img_mean, np.float32)) / np.asarray(
        data_cfg.img_std, np.float32
    )
    out = np.zeros(
        (data_cfg.pad_height, data_cfg.pad_width, 3), np.float32
    )
    out[:h, :w] = img
    return out, (h, w)


def device_preprocess(raw: Tensor, shapes: Tensor, data_cfg: DataConfig
                      ) -> Tuple[Tensor, Tensor]:
    """uint8 canvas -> normalised, padded float32 batch.

    ``raw``: (B, raw_height, raw_width, 3) uint8 (or float), each image
    pasted top-left at native resolution. ``shapes``: (B, 2) native (h, w).
    Returns the (B, pad_height, pad_width, 3) batch, zero outside each
    image, and (h, w) * test_scale. With test_scale != 1 the whole canvas
    is resized first (half-pixel bilinear, no antialiasing).
    """
    x = raw.float()
    s = float(data_cfg.test_scale)
    shapes = shapes.float()
    if s != 1.0:
        nh = int(round(raw.shape[1] * s))
        nw = int(round(raw.shape[2] * s))
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
            align_corners=False, antialias=False,
        ).permute(0, 2, 3, 1)
        shapes = torch.round(shapes * s)
    ph, pw = data_cfg.pad_height, data_cfg.pad_width
    x = x[:, :ph, :pw]
    x = F.pad(x, (0, 0, 0, pw - x.shape[2], 0, ph - x.shape[1]))
    mean = torch.tensor(data_cfg.img_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(data_cfg.img_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    # padding is 0 in NORMALISED space
    rows = torch.arange(ph, dtype=torch.float32, device=x.device)[None, :, None, None]
    cols = torch.arange(pw, dtype=torch.float32, device=x.device)[None, None, :, None]
    valid = (rows < shapes[:, 0, None, None, None]) & (
        cols < shapes[:, 1, None, None, None]
    )
    return torch.where(valid, x, torch.zeros_like(x)), shapes


def scale_intrinsics(cam: Tensor, test_scale: float) -> Tensor:
    """K for the resized image: focal lengths and principal point x s."""
    if float(test_scale) == 1.0:
        return cam
    scale = torch.tensor([[test_scale], [test_scale], [1.0]],
                         dtype=torch.float32, device=cam.device)
    return cam.float() * scale


def prepare_train_sample(
    ds: KITTI3DDataset,
    idx: int,
    data_cfg: DataConfig,
    rng: np.random.Generator,
    max_pts: int = 512,
) -> Dict[str, np.ndarray]:
    """One augmented sample with static GT/point capacities."""
    img = load_image(ds.image_path(idx), data_cfg.to_rgb)
    ann = ds.get_ann(idx)
    h, w = img.shape[:2]
    G = data_cfg.max_gt

    boxes = ann["bboxes"].copy()
    flip = bool(rng.uniform() < data_cfg.flip_ratio)

    sparse = ds.get_sparse_coords(idx, ann["object_ids"]) \
        if ds.coord_3d_prefix else None

    if flip:
        img = img[:, ::-1]
        if len(boxes):
            x1 = boxes[:, 0].copy()
            boxes[:, 0] = w - boxes[:, 2]
            boxes[:, 2] = w - x1
        ignore = ann["bboxes_ignore"].copy()
        if len(ignore):
            x1 = ignore[:, 0].copy()
            ignore[:, 0] = w - ignore[:, 2]
            ignore[:, 2] = w - x1
    else:
        ignore = ann["bboxes_ignore"]

    img = photometric_distortion(img, rng)
    img, (rh, rw) = normalize_pad(np.ascontiguousarray(img), data_cfg)

    n = min(len(boxes), G)
    gt_boxes = np.zeros((G, 4), np.float32)
    gt_labels = np.zeros((G,), np.int32)
    gt_valid = np.zeros((G,), bool)
    gt_3d = np.zeros((G, 7), np.float32)
    gt_3d[:, :3] = 1.0      # benign dims for padded slots
    gt_3d[:, 5] = 10.0      # keep padded objects in front of the camera
    gt_boxes[:n] = boxes[:n]
    gt_labels[:n] = ann["labels"][:n]
    gt_valid[:n] = True
    gt_3d[:n] = ann["bboxes_3d"][:n]

    n_ig = min(len(ignore), 16)
    ig_boxes = np.zeros((16, 4), np.float32)
    ig_valid = np.zeros((16,), bool)
    ig_boxes[:n_ig] = ignore[:n_ig]
    ig_valid[:n_ig] = True

    uv = np.zeros((G, max_pts, 2), np.float32)
    oc = np.zeros((G, max_pts, 3), np.float32)
    pts_valid = np.zeros((G, max_pts), bool)
    if sparse is not None:
        for gi in range(n):
            puv, poc = sparse[gi]
            if len(puv) == 0:
                continue
            if len(puv) > max_pts:
                sel = rng.choice(len(puv), max_pts, replace=False)
                puv, poc = puv[sel], poc[sel]
            if flip:
                puv = puv.copy()
                puv[:, 0] = (w - 1) - puv[:, 0]
            m = len(puv)
            uv[gi, :m] = puv
            oc[gi, :m] = poc
            pts_valid[gi, :m] = True

    return dict(
        images=img,
        cam=ann["cam_intrinsic"],
        img_shapes=np.asarray([float(rh), float(rw)], np.float32),
        scale_factor=np.ones(2, np.float32),
        crop_offset=np.zeros(2, np.float32),
        gt_boxes=gt_boxes,
        gt_labels=gt_labels,
        gt_valid=gt_valid,
        ignore_boxes=ig_boxes,
        ignore_valid=ig_valid,
        gt_bboxes_3d=gt_3d,
        flip=np.asarray(flip),
        uv=uv,
        oc=oc,
        pts_valid=pts_valid,
    )


def prepare_test_sample(
    ds: KITTI3DDataset, idx: int, data_cfg: DataConfig
) -> Dict[str, np.ndarray]:
    img = load_image(ds.image_path(idx), data_cfg.to_rgb)
    ann = ds.get_ann(idx)
    cam = ann["cam_intrinsic"]
    s = float(data_cfg.test_scale)
    if s != 1.0:
        # fast-preset downscale: image and intrinsics scale together so
        # the 3D geometry (PnP in metric space) is unchanged; predicted
        # 2D boxes are mapped back to native coords in apis/test.py
        h, w = img.shape[:2]
        img = cv2.resize(
            img, (int(round(w * s)), int(round(h * s))),
            interpolation=cv2.INTER_LINEAR,
        )
        cam = cam.copy()
        cam[:2] *= s
    img, (rh, rw) = normalize_pad(img, data_cfg)
    return dict(
        images=img,
        cam=cam,
        img_shapes=np.asarray([float(rh), float(rw)], np.float32),
    )


def collate(samples) -> Dict[str, np.ndarray]:
    return {
        k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]
    }
