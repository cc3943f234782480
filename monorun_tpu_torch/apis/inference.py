"""Inference API: build a detector from a config (and optionally a
reference checkpoint) and run it on batches; the PyTorch counterpart of
``monorun_tpu/apis/inference.py`` (``init_inference``,
``InferenceSession``, ``inference_detector``, ``read_calib_csv``).

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for another device; without a GPU they raise rather than move to the CPU.

Precision: the compute dtype is ``cfg.compute_dtype`` (bfloat16 for the
presets). Serving casts every >= 2-D weight to it once; biases and
normalisation statistics stay float32. TF32 is switched off for float32
matmuls and convolutions, so a float32 config computes in full float32,
as the JAX package does on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch

from ..config import MonoRUnConfig, get_config
from ..data.pipeline import load_image, normalize_pad
from ..models.detector import (
    Detections, HeadDraws, MonoRUn, compute_dtype, init_random_weights,
)
from ..utils.weights import load_pth


def upload(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One copy of a host array to ``device``; to a GPU it goes through
    pinned memory, without blocking the host."""
    t = torch.as_tensor(x, dtype=dtype)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; a CUDA request without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


class InferenceSession:
    """Holds the model on its device and runs batches.

    ``raw=False`` (the JAX package's default): ``run`` takes (B, H, W, 3)
    images already normalised and padded (``data/pipeline.py:
    normalize_pad``), the K of those images (B, 3, 3) and their (h, w)
    before padding (B, 2). ``raw=True`` serves uint8 canvases: (B,
    raw_height, raw_width, 3) with each image pasted top-left at native
    resolution, native intrinsics and native (h, w) shapes; resizing,
    normalising and padding then run on the device
    (``data/pipeline.py:device_preprocess``).
    """

    def __init__(self, cfg: MonoRUnConfig, model: MonoRUn, batch_size: int,
                 device: torch.device, raw: bool = False):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = device
        self.raw = raw
        dt = compute_dtype(cfg)
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() >= 2:
                    p.data = p.data.to(dt)
        self.model = model.to(device).eval()

    def run(self, images, cam, shapes, seed: int = 0,
            draws: HeadDraws = HeadDraws()) -> Detections:
        """One batch. The random draws that ``draws`` does not give come
        from a generator on the session's device seeded with ``seed``, so
        a result depends on the seed and not on the calls before it."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        fn = self.model.serve_raw if self.raw else self.model
        with torch.inference_mode():
            return fn(upload(images, self.device), upload(cam, self.device, torch.float32),
                      upload(shapes, self.device, torch.float32), draws, generator)


def serving_config(cfg: MonoRUnConfig, checkpoint: Optional[str],
                   explicit_lazy: bool = False) -> MonoRUnConfig:
    """The config a checkpoint is served with. A reference ``.pth``
    switches ``neck.lazy_lower`` off (its weights were trained on the
    dense stride-2 level), unless the caller set it deliberately
    (``explicit_lazy``)."""
    if (checkpoint and checkpoint.endswith(".pth") and cfg.neck.lazy_lower
            and not explicit_lazy):
        print("[init_inference] .pth checkpoint: neck.lazy_lower -> False "
              "(reference-faithful dense stride-2 level; override with "
              "--cfg-options neck.lazy_lower=True)")
        return dataclasses.replace(
            cfg, neck=dataclasses.replace(cfg.neck, lazy_lower=False)
        )
    return cfg


def load_weights(model: MonoRUn, checkpoint: str) -> MonoRUn:
    """Loads a reference ``.pth`` or the weights of a port checkpoint
    directory (``workdir/step_N``, ``utils/checkpoint.py``) into ``model``."""
    if checkpoint.endswith(".pth"):
        return load_pth(model, checkpoint)
    from ..utils.checkpoint import load_checkpoint

    load_checkpoint(checkpoint, model)
    return model


def init_inference(
    config: str | MonoRUnConfig,
    checkpoint: Optional[str] = None,
    batch_size: int = 1,
    explicit_lazy: bool = False,
    device: str | torch.device = "cuda",
    seed: int = 0,
    raw: bool = False,
) -> InferenceSession:
    """Build an InferenceSession from a preset name or config object.

    Without a checkpoint the weights are random, drawn from a
    ``torch.Generator`` seeded with ``seed``. A checkpoint is a reference
    ``.pth`` (``serving_config`` says how it sets ``neck.lazy_lower``) or
    a checkpoint directory of the port's training loop (``load_weights``).
    ``raw`` selects the session's input (``InferenceSession``).
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(config) if isinstance(config, str) else config
    cfg = serving_config(cfg, checkpoint, explicit_lazy)
    model = MonoRUn(cfg)
    if checkpoint:
        load_weights(model, checkpoint)
    else:
        init_random_weights(model, torch.Generator().manual_seed(seed))
    return InferenceSession(cfg, model, batch_size, device, raw=raw)


def _host(t: torch.Tensor) -> np.ndarray:
    if t.is_floating_point():
        t = t.float()
    return t.cpu().numpy()


def detections_to_host(det: Detections
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """A batch's detections as numpy, one copy per field (bfloat16 and
    device tensors cannot go to numpy directly): (fields, extras)."""
    fields = {k: _host(v) for k, v in det._asdict().items() if k != "extras"}
    return fields, {k: _host(v) for k, v in det.extras.items()}


def inference_detector(
    session: InferenceSession,
    image_paths: Sequence[str],
    cam_intrinsics: Sequence[np.ndarray],
    seed: int = 0,
) -> List[Dict[str, np.ndarray]]:
    """Run detection on image files; returns per-image result dicts
    (bboxes_2d, scores_2d, labels, bboxes_3d, valid, pose_cov) in numpy.
    Takes a session with ``raw=False``."""
    cfg = session.cfg
    results = []
    B = session.batch_size
    s = float(cfg.data.test_scale)
    for i in range(0, len(image_paths), B):
        chunk = image_paths[i : i + B]
        cams = [np.array(c) for c in cam_intrinsics[i : i + B]]
        if s != 1.0:
            for c in cams:
                c[:2] *= s
        imgs, shapes = [], []
        for p in chunk:
            img = load_image(p, cfg.data.to_rgb)
            if s != 1.0:
                h, w = img.shape[:2]
                img = cv2.resize(
                    img, (int(round(w * s)), int(round(h * s))),
                    interpolation=cv2.INTER_LINEAR,
                )
            padded, (rh, rw) = normalize_pad(img, cfg.data)
            imgs.append(padded)
            shapes.append([float(rh), float(rw)])
        while len(imgs) < B:   # pad the tail batch
            imgs.append(np.zeros_like(imgs[0]))
            cams.append(cams[-1])
            shapes.append(shapes[-1])
        det, _ = detections_to_host(session.run(
            np.stack(imgs), np.stack(cams).astype(np.float32),
            np.asarray(shapes, np.float32),
            seed=seed + i,
        ))
        for b in range(len(chunk)):
            results.append(dict(
                bboxes_2d=det["bboxes_2d"][b] / s,
                scores_2d=det["scores_2d"][b],
                labels=det["labels"][b],
                bboxes_3d=det["bboxes_3d"][b],
                valid=det["valid"][b],
                pose_cov=det["pose_cov"][b],
            ))
    return results


def read_calib_csv(path: str) -> np.ndarray:
    """demo/calib.csv style: 3x3 intrinsic matrix as comma-separated rows."""
    return np.loadtxt(path, delimiter=",").astype(np.float32).reshape(3, 3)
