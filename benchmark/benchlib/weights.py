"""Seeded random weights, made on the device in one draw.

The rules are the program's serving init (a plain normal of variance
1/fan_in for every >= 2-D weight, the NOC head's latent decoder zero,
normalisation scales and running variances one, every other parameter
and buffer zero), applied to one normal vector drawn on the device with
a ``torch.Generator`` seeded from ``--seed``. The same function fills
the program's model and the reference's, whose module trees have the
same names, so both get the same numbers.

One scale departs from the init: the score head's pose normaliser, whose
trained statistics bring the PnP's pose and covariance to unit scale.
Random weights give covariances over many orders of magnitude, which
would hold the 3D score's sigmoid at 0 or 1 and leave nothing of the
score head to compare; at a thousandth of the init's scale the 3D scores
spread over (0, 1)."""

from __future__ import annotations

from typing import Dict

import torch

LATENT = "roi_head.noc_head.latent_decoder.weight"
POSE_NORM = "roi_head.score_head.pose_norm.weight"
POSE_NORM_SCALE = 1e-3


def weight_values(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state of ``model`` (parameters and buffers, by name) from
    ``seed``, float32 on ``device``."""
    params = dict(model.named_parameters())
    drawn = [(k, p.shape) for k, p in params.items() if p.dim() >= 2 and k != LATENT]
    total = sum(s.numel() for _, s in drawn)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for k, shape in drawn:
        n = shape.numel()
        out[k] = z[at:at + n].view(shape) / shape[1:].numel() ** 0.5
        at += n
    for k, p in params.items():
        if k in out:
            continue
        one = k.endswith("weight") and p.dim() == 1
        out[k] = (torch.ones if one else torch.zeros)(p.shape, device=device)
    if POSE_NORM in out:
        out[POSE_NORM] *= POSE_NORM_SCALE
    for k, b in model.named_buffers():
        fill = torch.ones if k.endswith("running_var") else torch.zeros
        out[k] = fill(b.shape, dtype=b.dtype if not b.is_floating_point() else torch.float32,
                      device=device)
    return out


def build(model_cls, cfg, seed: int, device) -> torch.nn.Module:
    """``model_cls(cfg)`` made without allocating on the host, with the
    seed's weights on ``device``."""
    with torch.device("meta"):
        model = model_cls(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weight_values(model, seed, device), strict=True)
    return model
