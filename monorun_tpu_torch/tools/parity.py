"""Released-checkpoint parity runbook of the port (the counterpart of
``tools/parity.py``).

    python -m monorun_tpu_torch.tools.parity KITTI_ROOT CKPT.pth \
        [--config kitti_multiclass] [--batch-size 4] [--activations] \
        [--result-dir DIR] [--summary-file FILE] [--cfg-options ...] [--device cpu]

Runs the reference's validation protocol on KITTI's ``training/`` split
(``mono3dsplit_val_list.txt``) with a released ``.pth`` and every
serving deviation switched off, and prints the measured APs:

  - ``neck.lazy_lower = False``   the dense stride-2 FPN level the
                                  reference's weights were trained on
  - ``test.head_slots = 0``       the 3D heads on every one of the
                                  ``max_per_img`` detection slots
  - ``compute_dtype = float32``   no bfloat16 rounding (TF32 stays off,
                                  ``apis/inference.py:init_inference``)

``--activations`` also loads the same ``.pth`` into the plain-torch torso
replica ``tests/torch_ref/backbone.py:DetectorTorso`` (the reference's
key names, on the CPU in float32) and prints, stage by stage, how far the
port's backbone, FPN and RPN outputs on the first validation image are
from it: max|d| and max|d| over the stage's standard deviation. A layout
or ordering fault in the composed torso shows there before it shows as an
AP gap. The replica lives in the repository's tests, so the diff needs a
checkout; without one the tool says so and stops.

Runs on the GPU unless ``--device cpu`` is given. Compare the Car 3D and
BEV R40 rows with the reference implementation's evaluation of the same
checkpoint on the same split; val APs run higher than the published
test-server ones (BASELINE.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..apis.inference import init_inference
from ..apis.test import run_eval
from ..config import MonoRUnConfig, apply_overrides, get_config
from ..data.kitti import KITTI3DDataset
from ..data.pipeline import prepare_test_sample
from ..utils.compile_cache import enable_compilation_cache

REPLICA = Path(__file__).resolve().parents[2] / "tests" / "torch_ref" / "backbone.py"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Released-checkpoint parity run of the port")
    p.add_argument("kitti_root", help="KITTI object root holding training/ (image_2, "
                                      "calib, label_2) and the split list files")
    p.add_argument("checkpoint", help="a released (reference key names) .pth")
    p.add_argument("--config", default="kitti_multiclass")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--activations", action="store_true",
                   help="also diff the torso's activations against the plain-torch "
                        "replica on the first val image")
    p.add_argument("--result-dir", default=None)
    p.add_argument("--summary-file", default=None)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def parity_config(name: str, kitti_root: str, overrides: Sequence[str]) -> MonoRUnConfig:
    """The preset with the serving deviations off (``tools/parity.py:66-78``),
    then ``overrides``."""
    cfg = get_config(name)
    cfg = dataclasses.replace(
        cfg,
        compute_dtype="float32",
        neck=dataclasses.replace(cfg.neck, lazy_lower=False),
        test=dataclasses.replace(cfg.test, head_slots=0),
        data=dataclasses.replace(cfg.data, train_root=str(Path(kitti_root) / "training") + "/"),
    )
    return apply_overrides(cfg, list(overrides))


def load_replica(cfg: MonoRUnConfig, checkpoint: str) -> torch.nn.Module:
    """``DetectorTorso`` at the config's widths, holding the checkpoint's
    torso weights, on the CPU in float32."""
    if not REPLICA.exists():
        raise SystemExit(f"[activations] the plain-torch replica {REPLICA} is absent: the "
                         "activation diff needs the repository's tests/torch_ref (run from "
                         "a checkout), so it was not run")
    if cfg.rpn.feat_channels != cfg.neck.out_channels:
        raise SystemExit("[activations] the replica's RPN is as wide as the neck, and "
                         f"rpn.feat_channels={cfg.rpn.feat_channels} is not "
                         f"neck.out_channels={cfg.neck.out_channels}")
    spec = importlib.util.spec_from_file_location("torch_ref_backbone", REPLICA)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torso = mod.DetectorTorso(
        depth=cfg.backbone.depth, num_classes=cfg.bbox_head.num_classes,
        num_anchors=len(cfg.rpn.anchors.scales) * len(cfg.rpn.anchors.ratios),
        out_channels=cfg.neck.out_channels, fc_out_channels=cfg.bbox_head.fc_out_channels,
    )
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    missing, unexpected = torso.load_state_dict(sd, strict=False)
    print(f"[activations] torch replica: {len(missing)} replica keys missing from the "
          f"checkpoint, {len(unexpected)} checkpoint keys outside the torso (the 3D heads: "
          "diffed through the AP, not here)")
    return torso.float().eval()


def diff_activations(cfg: MonoRUnConfig, session, ds: KITTI3DDataset,
                     checkpoint: str) -> List[Tuple[str, float, float]]:
    """The port's backbone, FPN and RPN outputs on the first val image
    (prepared by the host pipeline) against the replica's: one (stage,
    max|d|, max|d| / the replica stage's std) per stage, printed too."""
    torso = load_replica(cfg, checkpoint)
    x = prepare_test_sample(ds, 0, cfg.data)["images"][None]       # (1, H, W, 3)
    model, dev = session.model, session.device
    with torch.inference_mode():
        feats = model.backbone(torch.from_numpy(x).to(dev, model.dtype))
        fpn = model.neck(feats)
        cls, reg = model.rpn_head(fpn[cfg.rpn.starting_level:])
        t_feats, t_fpn, t_cls, t_reg = torso.stages(
            torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))

    rows = []
    print("[activations] composed-pipeline stage deviations:")

    def report(tag, got, ref):
        got = got.float().cpu()
        ref = ref.permute(0, 2, 3, 1).float()
        scale = max(float(ref.std()), 1e-9)
        d = float((got - ref).abs().max())
        rows.append((tag, d, d / scale))
        print(f"  {tag:<28s} max|d| {d:10.3e}   ({d / scale:8.2e} of stage std {scale:.3e})")

    for i, (a, b) in enumerate(zip(feats, t_feats)):
        report(f"backbone C{i + 2}", a, b)
    for i, (a, b) in enumerate(zip(fpn, t_fpn)):
        report(f"fpn P{i + 1} (stride {2 ** (i + 1)})", a, b)
    for i, (a, b) in enumerate(zip(cls, t_cls)):
        report(f"rpn cls lvl {i}", a, b)
    for i, (a, b) in enumerate(zip(reg, t_reg)):
        report(f"rpn reg lvl {i}", a, b)
    want = len(t_feats) + len(t_fpn) + len(t_cls) + len(t_reg)
    if len(rows) != want:
        raise SystemExit(f"[activations] the port gave {len(rows)} stages, the replica {want}")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Returns ``ap`` (the AP dict), ``activations`` (``diff_activations``'
    rows, or None) and ``cfg`` (the config served)."""
    args = parse_args(argv)
    enable_compilation_cache()
    cfg = parity_config(args.config, args.kitti_root, args.cfg_options)
    print(f"[parity] deviations OFF: lazy_lower={cfg.neck.lazy_lower} "
          f"head_slots={cfg.test.head_slots} dtype={cfg.compute_dtype}")
    ds = KITTI3DDataset(cfg.data.train_root, cfg.data.val_list, classes=cfg.data.classes,
                        with_labels=True)
    print(f"[parity] val split: {len(ds)} images from {cfg.data.train_root}")
    session = init_inference(cfg, args.checkpoint, batch_size=args.batch_size,
                             explicit_lazy=True,     # lazy_lower=False is set above
                             device=args.device)
    activations = (diff_activations(cfg, session, ds, args.checkpoint)
                   if args.activations else None)
    ap = run_eval(session, ds, batch_size=args.batch_size, metrics=("bbox", "bev", "3d"),
                  result_dir=args.result_dir, print_summary=True)
    if args.summary_file:
        with open(args.summary_file, "w") as f:
            json.dump(ap, f, indent=2)
        print(f"[parity] summary -> {args.summary_file}")
    print("[parity] compare Car_3d/Car_bev R40 rows against the reference "
          "implementation's eval of the SAME checkpoint on this split "
          "(reference tools/test.py --val-set); published test-server "
          "anchors are in BASELINE.md.")
    return dict(ap=ap, activations=activations, cfg=session.cfg)


if __name__ == "__main__":
    main()
