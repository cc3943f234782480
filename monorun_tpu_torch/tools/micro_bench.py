"""Op-level micro-benchmarks of the port's inference hot path on one CUDA
GPU: the counterpart of ``tools/micro_bench.py``.

    python -m monorun_tpu_torch.tools.micro_bench [batch] [op ...]

Ops: pyramid align7k align7 align14 align48 global noc carafe pnp proposals
(all of them by default). Inputs are the serving path's: a batch of FPN
levels of a 384x1280 canvas, C=256, bfloat16, at the align strides of
``kitti_multiclass`` (4, 4, 8, 16, 32: the lazy lower level), KITTI-like
RoIs (log-uniform 16-420 px, aspect 0.4-2.5) made from a seed, and the
preset's align settings (finest scale 20 / 28, sampling cap 6 / 4).

* ``pyramid``: ``prepare_flat_pyramid``, the staged kernels' buffers;
* ``align7k`` / ``align7`` / ``align14``: ``multilevel_roi_align_auto``
  at 1000 / 100 / 100 RoIs per image, with the pyramid it asks for,
  dispatched by the environment (``MONORUN_ALIGN_IMPL`` and friends);
* ``align48``: an A/B over every implementation at the serving
  head-slot count (48 per image), 7x7 and 14x14: ``gather``, ``sorted``
  and ``band`` (the direct kernel), ``tiered``, ``bandmm``,
  ``bandmm_t1bf16``, ``packed`` (``multilevel_roi_align_band(packed=True)``)
  and ``tile`` (``multilevel_roi_align_tile``), each with its preparation;
* ``global``, ``noc``, ``carafe``, ``pnp``, ``proposals``: the port's
  modules at 100 detections per image, seeded random weights.

Timing: CUDA events around one call, median of ``REPS`` calls, each after
an L2 flush (a 256 MB write) and a spin on the card that outlasts the
host's launch of the call, after one warm-up call. Prints the card's
name and power limit, then one line per op and implementation, and one
JSON line of all records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..config import get_config
from ..ops import roi_align as ra
from ..ops.roi_align_band import multilevel_roi_align_band
from ..ops.roi_align_tile import multilevel_roi_align_tile, prepare_flat_pyramid
from ..utils.compile_cache import enable_compilation_cache

OPS = ("pyramid", "align7k", "align7", "align14", "align48", "global", "noc", "carafe",
       "pnp", "proposals")
REPS = 15
# card clock cycles of the spin before each timed call: about 0.5 ms at the
# H100's 1.98 GHz, longer than the host takes to enqueue one wrapper call
SPIN_CYCLES = 1_000_000
ENV_NAMES = ("MONORUN_ALIGN_IMPL", "MONORUN_BAND_TIERED", "MONORUN_BAND_MATMUL",
             "MONORUN_BAND_KROI", "MONORUN_BAND_T1_BF16")
# align48 implementations set through the environment
ALIGN_ENV: Dict[str, Dict[str, str]] = {
    "gather": {"MONORUN_ALIGN_IMPL": "gather"},
    "sorted": {"MONORUN_ALIGN_IMPL": "sorted"},
    "band": {"MONORUN_ALIGN_IMPL": "band"},
    "tiered": {"MONORUN_ALIGN_IMPL": "band", "MONORUN_BAND_TIERED": "1"},
    "bandmm": {"MONORUN_ALIGN_IMPL": "bandmm"},
    "bandmm_t1bf16": {"MONORUN_ALIGN_IMPL": "bandmm", "MONORUN_BAND_T1_BF16": "1"},
}
AB_IMPLS = tuple(ALIGN_ENV) + ("packed", "tile")


def device_ms(fn: Callable, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each after an L2
    flush (a write larger than the 50 MB cache), by CUDA events. The card
    spins between the flush and the start event, so ``fn``'s kernels are
    queued before the start event fires and the host's time in ``fn``
    stays outside the measurement while it is shorter than the spin."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


@contextlib.contextmanager
def align_env(overrides: Dict[str, str]):
    """The align switches set to ``overrides`` (others unset), restored
    afterwards."""
    saved = {k: os.environ.get(k) for k in ENV_NAMES}
    for k in ENV_NAMES:
        os.environ.pop(k, None)
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kitti_rois(n_per_img: int, batch: int, rng: np.random.Generator, dev) -> torch.Tensor:
    """KITTI-like RoI mix: log-uniform scale 16-420 px, aspect 0.4-2.5."""
    n = batch * n_per_img
    sc = np.exp(rng.uniform(np.log(16), np.log(420), n))
    ar = np.exp(rng.uniform(np.log(0.4), np.log(2.5), n))
    bw, bh = sc * np.sqrt(ar), sc / np.sqrt(ar)
    cx, cy = rng.uniform(0, 1242, n), rng.uniform(0, 375, n)
    boxes = np.stack([
        np.repeat(np.arange(batch), n_per_img),
        np.clip(cx - bw / 2, 0, 1279), np.clip(cy - bh / 2, 0, 383),
        np.clip(cx + bw / 2, 1, 1280), np.clip(cy + bh / 2, 1, 384),
    ], 1).astype(np.float32)
    return torch.from_numpy(boxes).to(dev)


def align_fn(impl: str, feats, rois, strides, size: int, finest: float, mr: int,
             tile_h: int) -> Callable:
    """One align call of ``impl`` with its preparation (pyramid included)."""
    out_size = (size, size)
    if impl == "packed":
        return lambda: multilevel_roi_align_band(
            feats, rois, strides, out_size, finest, max_ratio=mr,
            tile_hw=(max(tile_h, 32), 96), kroi=4, packed=True)
    if impl == "tile":
        return lambda: multilevel_roi_align_tile(
            feats, rois, strides, out_size, finest, max_ratio=mr,
            tile_hw=(max(tile_h, 32), 96))

    def call():
        return ra.multilevel_roi_align_auto(feats, rois, strides, out_size, finest,
                                            max_ratio=mr, tile_h=tile_h,
                                            pyramid=ra.prepare_pyramid(feats))
    return call


def _random_module(module: torch.nn.Module, gen: torch.Generator, dtype) -> torch.nn.Module:
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() >= 2 else 1
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
    module = module.cuda().eval()
    for p in module.parameters():
        if p.dim() >= 2:
            p.data = p.data.to(dtype)
    return module


def run(batch: int = 8, ops: Sequence[str] = OPS, reps: int = REPS) -> List[dict]:
    """Times the chosen ops; prints and returns one record per timing."""
    if not torch.cuda.is_available():
        raise RuntimeError("the micro-benchmarks need a CUDA device")
    unknown = set(ops) - set(OPS)
    if unknown:
        raise ValueError(f"unknown ops {sorted(unknown)}; choose from {OPS}")
    dev = torch.device("cuda")
    cfg = get_config("kitti_multiclass")
    bh, nh = cfg.bbox_head, cfg.noc_head
    C, dt = cfg.neck.out_channels, torch.bfloat16
    strides = ra.align_strides(cfg.neck.lazy_lower, bh.featmap_strides)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = [torch.randn(batch, 384 // s, 1280 // s, C, generator=gen, device=dev).to(dt)
             for s in strides]
    rng = np.random.default_rng(0)
    rois = {n: kitti_rois(n, batch, rng, dev) for n in (1000, 100, 48)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    records: List[dict] = []

    def timeit(name: str, fn: Callable, **extra):
        with torch.inference_mode():
            ms = device_ms(fn, reps, flush)
        print(f"{name:>28s}: {ms:9.4f} ms/call", flush=True)
        records.append(dict(op=name, ms=ms, **extra))

    a7 = (7, bh.finest_scale, bh.align_max_ratio, 24)
    a14 = (nh.roi_size, nh.finest_scale, nh.align_max_ratio, 32)
    if "pyramid" in ops:
        timeit("pyramid", lambda: prepare_flat_pyramid(feats))
    for op, n, args in (("align7k", 1000, a7), ("align7", 100, a7), ("align14", 100, a14)):
        if op in ops:
            timeit(f"{op}+pyr", align_fn("auto", feats, rois[n], strides, *args),
                   rois=int(rois[n].shape[0]),
                   impl=ra.align_choice(rois[n].shape[0], dt, True).impl)
    if "align48" in ops:
        for impl in AB_IMPLS:
            with align_env(ALIGN_ENV.get(impl, {})):
                for size, finest, mr, th in (a7, a14):
                    timeit(f"align{size}_48[{impl}]",
                           align_fn(impl, feats, rois[48], strides, size, finest, mr, th),
                           rois=int(rois[48].shape[0]), impl=impl)

    n_det = batch * 100
    wgen = torch.Generator().manual_seed(0)
    x7 = torch.randn(n_det, 7, 7, C, generator=gen, device=dev).to(dt)
    x14 = torch.randn(n_det, nh.roi_size, nh.roi_size, C, generator=gen, device=dev).to(dt)
    if "global" in ops:
        from ..models.global_head import GlobalHead

        gh = _random_module(GlobalHead(dataclasses.replace(cfg.global_head, in_channels=C)),
                            wgen, dt)
        timeit("global_mc", lambda: gh(x7, generator=gen).dim_latent_pred)
    if "noc" in ops:
        from ..models.noc_head import NOCHead

        noc = _random_module(NOCHead(dataclasses.replace(nh, in_channels=C)), wgen, dt)
        lat = torch.randn(n_det, nh.latent_channels, generator=gen, device=dev).to(dt)
        lbl = torch.randint(0, 3, (n_det,), generator=gen, device=dev)
        flp = torch.zeros(n_det, dtype=torch.bool, device=dev)
        timeit("noc_head", lambda: noc(x14, lat, lbl, flp).noc_pred)
    if "carafe" in ops:
        from ..ops.carafe import CARAFEPack

        cp = _random_module(CARAFEPack(C), wgen, dt)
        timeit("carafe", lambda: cp(x14))
    if "pnp" in ops:
        from ..ops.pnp import PnPConfig, pnp_uncert

        n_pts = 784
        c2d = torch.rand(n_det, n_pts, 2, generator=gen, device=dev) * 1000
        istd = 0.5 + 1.5 * torch.rand(n_det, n_pts, 2, generator=gen, device=dev)
        c3d = torch.randn(n_det, n_pts, 3, generator=gen, device=dev)
        cams = torch.tensor([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1]],
                            device=dev).expand(n_det, 3, 3).contiguous()
        ur = torch.tensor([[-200.0, 1442.0]], device=dev).expand(n_det, 2).contiguous()
        vr = torch.tensor([[-200.0, 575.0]], device=dev).expand(n_det, 2).contiguous()
        thr = torch.full((n_det,), 20.0, device=dev)
        timeit("pnp", lambda: pnp_uncert(c2d, istd, c3d, cams, ur, vr, ransac_thr=thr,
                                         cfg=PnPConfig(), generator=gen).t_vec)
    if "proposals" in ops:
        from ..models.rpn import RPNHead, get_proposals

        n_anchors = len(cfg.rpn.anchors.scales) * len(cfg.rpn.anchors.ratios)
        rh = _random_module(RPNHead(C, cfg.rpn.feat_channels, n_anchors), wgen, dt)
        rpn_feats = feats[1:] + [feats[-1][:, ::2, ::2]]
        shapes = torch.tensor([[375.0, 1242.0]], device=dev).expand(batch, 2)

        def proposals():
            cls_s, bb_p = rh(rpn_feats)
            return get_proposals(cls_s, bb_p, cfg.rpn, (384, 1280), 1000, 1000,
                                 valid_shapes=shapes)[0]
        timeit("rpn+proposals", proposals)
    return records


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def main(argv: Sequence[str]) -> int:
    enable_compilation_cache()
    batch = int(argv[0]) if argv else 8
    ops = tuple(argv[1:]) or OPS
    print(f"card {card_line()}", flush=True)
    records = run(batch, ops)
    print(json.dumps({"batch": batch, "records": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
