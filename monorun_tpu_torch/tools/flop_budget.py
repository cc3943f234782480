"""FLOPs per stage of the port's serving forward (the counterpart of
``tools/flop_budget.py``).

    python -m monorun_tpu_torch.tools.flop_budget [batch] [config] \
        [--cfg-options ...] [--device cpu]

Counts with ``torch.utils.flop_counter.FlopCounterMode`` over three
cumulative prefixes of the real forward at the preset's pad (seeded
random weights, a seeded normal batch): the backbone, the backbone and
FPN, and the whole ``MonoRUn.forward``. The neck is built with the dense
stride-2 level (``neck.lazy_lower=False``, the reference's and the parity
run's FPN; ``--cfg-options neck.lazy_lower=True`` counts the serving
default's stride-4 lower level instead). It prints cumulative GFLOP per
image and each prefix's delta.

It counts matrix products and convolutions (2 FLOPs a multiply-add), as
FlopCounterMode does: elementwise work, the RoI aligns (hand-written
kernels), NMS and the PnP's small solves are not in it, where XLA's
``cost_analysis`` in the JAX tool counts elementwise ops too.

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..apis.inference import init_inference
from ..config import MonoRUnConfig, apply_overrides, get_config
from .profile_stages import KITTI_HW, KITTI_K


def budget_config(config: str, overrides: Sequence[str] = ()) -> MonoRUnConfig:
    cfg = get_config(config)
    cfg = dataclasses.replace(cfg, neck=dataclasses.replace(cfg.neck, lazy_lower=False))
    return apply_overrides(cfg, list(overrides))


def count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def flop_budget(cfg: MonoRUnConfig, batch: int, device: str | torch.device
                ) -> List[Tuple[str, int, int]]:
    """(prefix, cumulative FLOPs, delta) of the batch, for ``backbone``,
    ``backbone_fpn`` and ``forward``."""
    session = init_inference(cfg, batch_size=batch, device=device, seed=0)
    model, dev = session.model, session.device
    h, w = cfg.data.pad_height, cfg.data.pad_width
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(batch, h, w, 3, generator=gen, device=dev)
    cam = torch.tensor(KITTI_K, device=dev).expand(batch, 3, 3)
    shapes = torch.tensor([[min(KITTI_HW[0], h), min(KITTI_HW[1], w)]], dtype=torch.float32,
                          device=dev).expand(batch, 2)
    rows, prev = [], 0
    with torch.inference_mode():
        for name, fn in (("backbone", lambda: model.backbone(images.to(model.dtype))),
                         ("backbone_fpn", lambda: model.extract_feats(images)),
                         ("forward", lambda: session.run(images, cam, shapes))):
            flops = count(fn)
            rows.append((name, flops, flops - prev))
            prev = flops
    return rows


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="FLOPs per stage of the serving forward")
    p.add_argument("batch", nargs="?", type=int, default=1)
    p.add_argument("config", nargs="?", default="kitti_multiclass")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple[str, int, int]]:
    args = parse_args(argv)
    cfg = budget_config(args.config, args.cfg_options)
    rows = flop_budget(cfg, args.batch, args.device)
    lower = "lazy stride-4" if cfg.neck.lazy_lower else "dense stride-2"
    print(f"{args.config} batch={args.batch} image={cfg.data.pad_height}x"
          f"{cfg.data.pad_width} FPN lower level {lower} (FlopCounterMode: matrix "
          "products and convolutions only)")
    for name, cum, delta in rows:
        print(f"{name:>14}: cum {cum / 1e9 / args.batch:9.2f} GFLOP/img   "
              f"delta {delta / 1e9 / args.batch:9.2f}")
    return rows


if __name__ == "__main__":
    main()
