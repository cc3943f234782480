"""Inference API: build a detector from a config (and optionally a
reference checkpoint) and serve uint8 canvases; the PyTorch counterpart
of ``monorun_tpu/apis/inference.py`` (``init_inference``,
``InferenceSession`` with ``raw=True``).

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
from typing import Optional

import torch

from ..config import MonoRUnConfig, get_config
from ..models.detector import (
    Detections, HeadDraws, MonoRUn, compute_dtype, init_random_weights,
)
from ..utils.weights import load_pth


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; a CUDA request without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


class InferenceSession:
    """Holds the model on its device and serves batches of uint8 canvases:
    ``run`` takes (B, raw_height, raw_width, 3) uint8 canvases with each
    image pasted top-left at native resolution, native intrinsics (B, 3, 3)
    and native (h, w) shapes (B, 2)."""

    def __init__(self, cfg: MonoRUnConfig, model: MonoRUn, batch_size: int,
                 device: torch.device, seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        dt = compute_dtype(cfg)
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() >= 2:
                    p.data = p.data.to(dt)
        self.model = model.to(device).eval()

    def run(self, raw, cams, raw_shapes, draws: HeadDraws = HeadDraws()
            ) -> Detections:
        def dev(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        with torch.inference_mode():
            return self.model.serve_raw(
                dev(raw), dev(cams, torch.float32), dev(raw_shapes, torch.float32),
                draws, self.generator,
            )


def init_inference(
    config: str | MonoRUnConfig,
    checkpoint: Optional[str] = None,
    batch_size: int = 1,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> InferenceSession:
    """Build an InferenceSession from a preset name or config object.

    Without a checkpoint the weights are random, drawn from a
    ``torch.Generator`` seeded with ``seed``. Loading a reference ``.pth``
    switches ``neck.lazy_lower`` off: those weights were trained on the
    dense stride-2 level.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(config) if isinstance(config, str) else config
    if checkpoint and cfg.neck.lazy_lower:
        cfg = dataclasses.replace(
            cfg, neck=dataclasses.replace(cfg.neck, lazy_lower=False)
        )
    model = MonoRUn(cfg)
    if checkpoint:
        load_pth(model, checkpoint)
    else:
        init_random_weights(model, torch.Generator().manual_seed(seed))
    return InferenceSession(cfg, model, batch_size, device, seed)
