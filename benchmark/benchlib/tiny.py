"""A cell shrunk to CPU size for the benchmark's own CPU tests: the same
files and code, with the backbone's depth, the canvas, the proposals,
the slots and the traffic's sizes cut by dotted-path overrides (the
heads keep their widths, at which the PnP finds poses)."""

from __future__ import annotations

import copy
from typing import Any, Dict

from .spec import Cell

H, W = 128, 416

CONFIG = {
    "backbone.depth": 26,
    "test.rpn_nms_pre": 512, "test.rpn_nms_post": 512, "test.max_per_img": 100,
    "test.head_slots": 48,
    "data.pad_height": H, "data.pad_width": W, "data.raw_height": H, "data.raw_width": W,
}

# narrower still, in float32: where the program and the reference must
# agree to round-off and the PnP need not find poses
NARROW = dict(CONFIG, **{
    "compute_dtype": "float32",
    "neck.out_channels": 64, "rpn.feat_channels": 64,
    "bbox_head.fc_out_channels": 128,
    "global_head.mc_samples": 2, "global_head.fc_out_channels": 128,
    "noc_head.conv_out_channels": 64, "noc_head.carafe_compressed_channels": 16,
    "score_head.reg_fc_out_channels": 128, "score_head.pose_fc_out_channels": 128,
    "score_head.fc_out_channels": 64,
})

TRAFFIC = {"image_hw": [120, 400], "pool": 4, "batches": 2, "draw_sets": 2,
           "trace_requests": 2, "check_requests": 2,
           "K": [[232.0, 0.0, 196.0], [0.0, 232.0, 56.0], [0.0, 0.0, 1.0]]}


def set_path(d: Dict[str, Any], path: str, value: Any) -> None:
    *head, last = path.split(".")
    for k in head:
        d = d[k]
    d[last] = value


def tiny(cell: Cell, batch: int = 2, config: Dict[str, Any] = CONFIG,
         traffic: Dict[str, Any] = TRAFFIC) -> Cell:
    out = copy.deepcopy(cell)
    for k, v in config.items():
        set_path(out.config["config"], k, v)
    out.traffic.update(traffic, batch=batch)
    return out

