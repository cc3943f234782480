"""Serving traffic: a pool of synthetic KITTI-like scenes made from the
seed, assembled into the request batches of a closed loop.

A scene is the frozen generator's idea (``monorun_ref/utils/
synthetic.py:synthetic_scene_batch``) made in bulk with torch: 3D boxes
standing on a ground plane 1.65 m below the camera, ray-cast through the
scene's intrinsics; each covered pixel shows the z-scored NOC code of
the surface point it sees (nearest object first), the rest is noise.
The float image becomes a uint8 canvas by the configuration's own
normalisation, pasted top-left on a ``raw_height`` x ``raw_width``
canvas, as the program's ``raw=True`` path takes it."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class Requests:
    """``batches[i]``: (canvases uint8 (B, H, W, 3), K (B, 3, 3), (h, w)
    (B, 2)) host arrays of distinct request batch ``i``."""

    batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    batch: int

    def __getitem__(self, i: int):
        return self.batches[i % len(self.batches)]


def scene_params(traffic: Dict, seed: int, n: int) -> Dict[str, torch.Tensor]:
    """Every random size of ``n`` scenes, drawn on the CPU from the seed."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = traffic["objects"]
    O = hi

    def u(a, b, shape=(n, O)):
        return a + (b - a) * torch.rand(shape, generator=g, dtype=torch.float64)

    count = torch.randint(lo, hi + 1, (n,), generator=g)
    return dict(
        present=torch.arange(O)[None, :] < count[:, None],
        L=u(3.4, 4.4), H=u(1.4, 1.7), W=u(1.5, 1.8),
        z=u(*traffic["depth_m"]), u=u(0.05, 0.95), ry=u(-math.pi, math.pi),
        noise_seed=torch.randint(0, 2 ** 62, (1,), generator=g),
    )


def render(params, K: torch.Tensor, hw: Tuple[int, int], noc_means, noc_stds,
           device) -> torch.Tensor:
    """(n, h, w, 3) float32 scenes: NOC texture over noise."""
    n, O = params["present"].shape
    h, w = hw
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    f64 = dict(dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    rays = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)], -1).reshape(-1, 3)
    mean = torch.tensor(noc_means, **f64)
    std = torch.tensor(noc_stds, **f64)
    g = torch.Generator(device=device).manual_seed(int(params["noise_seed"]))
    out = 0.25 * torch.randn((n, h * w, 3), generator=g, **f64)
    for s in range(n):
        best = torch.full((h * w,), float("inf"), **f64)
        code = torch.zeros((h * w, 3), **f64)
        for j in range(O):
            if not bool(params["present"][s, j]):
                continue
            L, H, W = (float(params[k][s, j]) for k in ("L", "H", "W"))
            z, ry = float(params["z"][s, j]), float(params["ry"][s, j])
            x = (float(params["u"][s, j]) * w - cx) * z / fx
            y = 1.65                                     # the ground, below the camera
            c, si = math.cos(ry), math.sin(ry)
            R = torch.tensor([[c, 0, si], [0, 1, 0], [-si, 0, c]], **f64)
            t = torch.tensor([x, y, z], **f64)
            o = -R.T @ t                                 # camera centre, object frame
            d = rays @ R                                 # rays, object frame
            lo = torch.tensor([-L / 2, -H, -W / 2], **f64)
            hi = torch.tensor([L / 2, 0.0, W / 2], **f64)
            safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
            t1, t2 = (lo - o) / safe, (hi - o) / safe
            tmin = torch.minimum(t1, t2).amax(1)
            tmax = torch.maximum(t1, t2).amin(1)
            hit = (tmax >= tmin.clamp(min=1e-3)) & (tmin > 0) & (tmin < best)
            pts = o + tmin[:, None] * d
            dims = torch.tensor([L, H, W], **f64)
            code = torch.where(hit[:, None], (pts / dims - mean) / std, code)
            best = torch.where(hit, tmin, best)
        out[s] = torch.where(best[:, None] < float("inf"), code, out[s])
    return out.reshape(n, h, w, 3)


def to_canvas(images: torch.Tensor, raw_hw: Tuple[int, int], img_mean, img_std) -> torch.Tensor:
    """Float scenes -> uint8 canvases the configuration's normalisation
    maps back to them (to a step of 1/255 of a std)."""
    mean = torch.tensor(img_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(img_std, dtype=torch.float32, device=images.device)
    px = torch.round(images * std + mean).clamp(0, 255).to(torch.uint8)
    n, h, w, _ = px.shape
    canvas = torch.zeros((n,) + tuple(raw_hw) + (3,), dtype=torch.uint8, device=images.device)
    canvas[:, :h, :w] = px
    return canvas


def make_requests(cfg: Dict, traffic: Dict, seed: int, device) -> Requests:
    """The cell's distinct request batches from the seed: a pool of scenes
    rendered on ``device``, then ``traffic["batches"]`` batches of
    ``traffic["batch"]`` scenes drawn from it."""
    data = cfg["data"]
    h, w = traffic["image_hw"]
    K = torch.tensor(traffic["K"], dtype=torch.float64)
    pool = traffic["pool"]
    params = scene_params(traffic, seed, pool)
    scenes = render(params, K, (h, w), cfg["noc_head"]["noc_means"],
                    cfg["noc_head"]["noc_stds"], device)
    canvas = to_canvas(scenes, (data["raw_height"], data["raw_width"]),
                       data["img_mean"], data["img_std"]).cpu().numpy()
    rng = np.random.default_rng(seed)
    B = traffic["batch"]
    batches = []
    for _ in range(traffic["batches"]):
        idx = rng.permutation(pool)[:B] if B <= pool else rng.integers(0, pool, B)
        batches.append((
            np.ascontiguousarray(canvas[idx]),
            np.tile(np.asarray(traffic["K"], np.float32), (B, 1, 1)),
            np.tile(np.asarray([[h, w]], np.float32), (B, 1)),
        ))
    return Requests(batches, B)


def head_draws(cfg: Dict, batch: int, dtype: torch.dtype, generator: torch.Generator,
               device) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Every random input of one served batch's heads, made by the
    benchmark: the global head's MC-dropout masks (pre-scaled, in the
    compute dtype; ``models/global_head.py:mc_dropout_masks``'s rule) and
    the PnP's RANSAC keys (uniform in [0, 1))."""
    gh, K = cfg["global_head"], head_slots(cfg)
    n, S = batch * K, gh["mc_samples"]
    C, F = cfg["neck"]["out_channels"], gh["fc_out_channels"]

    def mask(shape, keep):
        u = torch.rand(shape, generator=generator, device=device)
        return torch.where(u < keep, 1.0 / keep, 0.0).to(dtype)

    keep2d, keep = 1.0 - gh["dropout2d_rate"], 1.0 - gh["dropout_rate"]
    masks = (mask((n, S, C), keep2d), mask((n, S, F), keep), mask((n, S, F), keep))
    dsz = cfg["noc_head"]["dense_size"]
    keys = torch.rand((n, cfg["pose_head"]["ransac_hypotheses"], dsz * dsz),
                      generator=generator, device=device)
    return masks, keys


def head_slots(cfg: Dict) -> int:
    """K, the detections per image the heads serve
    (``models/detector.py:head_slot_count``)."""
    t = cfg["test"]
    return t["head_slots"] if 0 < t["head_slots"] < t["max_per_img"] else t["max_per_img"]

