"""Weights in and out of the port's state dict (reference mmdet key names).

* ``load_pth`` reads a reference ``.pth`` (or a saved port state dict) and
  loads it with ``load_state_dict``, dropping the keys that carry no
  serving weight (BatchNorm ``num_batches_tracked``, the projection loss's
  running scale).
* ``from_jax_params`` turns the JAX package's variables (``params`` and
  ``batch_stats`` trees of numpy arrays) into the port's state dict. It is
  the inverse of the JAX package's ``.pth`` converter
  (``monorun_tpu/utils/checkpoint.py``): the table below is this package's
  own copy of its key rules, read from the JAX side; conv kernels go
  HWIO -> OIHW and dense kernels (in, out) -> (out, in).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# (JAX leaf path regex, torch key template, kind); kind in conv, fc, raw
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_RULES: Tuple[Tuple[str, str, str], ...] = (
    (r"backbone/conv1/kernel", "backbone.conv1.weight", "conv"),
    (r"backbone/bn1/(\w+)", "backbone.bn1.{bn1}", "raw"),
    (r"backbone/layer(\d)_(\d+)/(conv\d)/kernel",
     "backbone.layer{1}.{2}.{3}.weight", "conv"),
    (r"backbone/layer(\d)_(\d+)/(bn\d)/(\w+)",
     "backbone.layer{1}.{2}.{3}.{bn4}", "raw"),
    (r"backbone/layer(\d)_(\d+)/downsample_conv/kernel",
     "backbone.layer{1}.{2}.downsample.0.weight", "conv"),
    (r"backbone/layer(\d)_(\d+)/downsample_bn/(\w+)",
     "backbone.layer{1}.{2}.downsample.1.{bn3}", "raw"),
    (r"neck/lateral(\d)/kernel", "neck.lateral_convs.{1}.conv.weight", "conv"),
    (r"neck/lateral(\d)/bias", "neck.lateral_convs.{1}.conv.bias", "raw"),
    (r"neck/fpn(\d)/kernel", "neck.fpn_convs.{1}.conv.weight", "conv"),
    (r"neck/fpn(\d)/bias", "neck.fpn_convs.{1}.conv.bias", "raw"),
    (r"neck/lower(\d)/kernel", "neck.lower_fpn_convs.{1}.conv.weight", "conv"),
    (r"neck/lower(\d)/bias", "neck.lower_fpn_convs.{1}.conv.bias", "raw"),
    (r"rpn_head/(rpn_conv|rpn_cls|rpn_reg)/kernel", "rpn_head.{1}.weight", "conv"),
    (r"rpn_head/(rpn_conv|rpn_cls|rpn_reg)/bias", "rpn_head.{1}.bias", "raw"),
    (r"bbox_head/shared_fc(\d)/kernel",
     "roi_head.bbox_head.shared_fcs.{1}.weight", "fc"),
    (r"bbox_head/shared_fc(\d)/bias", "roi_head.bbox_head.shared_fcs.{1}.bias", "raw"),
    (r"bbox_head/(fc_cls|fc_reg)/kernel", "roi_head.bbox_head.{1}.weight", "fc"),
    (r"bbox_head/(fc_cls|fc_reg)/bias", "roi_head.bbox_head.{1}.bias", "raw"),
    (r"global_head/fc0_kernel", "roi_head.global_head.fcs.0.weight", "fc"),
    (r"global_head/fc0_bias", "roi_head.global_head.fcs.0.bias", "raw"),
    (r"global_head/fc1/kernel", "roi_head.global_head.fcs.1.weight", "fc"),
    (r"global_head/fc1/bias", "roi_head.global_head.fcs.1.bias", "raw"),
    (r"global_head/fc_reg/kernel", "roi_head.global_head.fc_reg.weight", "fc"),
    (r"global_head/fc_reg/bias", "roi_head.global_head.fc_reg.bias", "raw"),
    (r"noc_head/conv(\d)/kernel", "roi_head.noc_head.convs.{1}.conv.weight", "conv"),
    (r"noc_head/conv(\d)/bias", "roi_head.noc_head.convs.{1}.conv.bias", "raw"),
    (r"noc_head/conv_up(\d)/kernel",
     "roi_head.noc_head.convs_upsampled.{1}.conv.weight", "conv"),
    (r"noc_head/conv_up(\d)/bias",
     "roi_head.noc_head.convs_upsampled.{1}.conv.bias", "raw"),
    (r"noc_head/latent_decoder/kernel", "roi_head.noc_head.latent_decoder.weight", "fc"),
    (r"noc_head/latent_decoder/bias", "roi_head.noc_head.latent_decoder.bias", "raw"),
    (r"noc_head/upsample/(channel_compressor|content_encoder)/kernel",
     "roi_head.noc_head.upsample.{1}.weight", "conv"),
    (r"noc_head/upsample/(channel_compressor|content_encoder)/bias",
     "roi_head.noc_head.upsample.{1}.bias", "raw"),
    (r"noc_head/conv_final/kernel", "roi_head.noc_head.conv_final.weight", "conv"),
    (r"noc_head/conv_final/bias", "roi_head.noc_head.conv_final.bias", "raw"),
    (r"score_head/pose_norm/(\w+)", "roi_head.score_head.pose_norm.{bn1}", "raw"),
    (r"score_head/pose_fc(\d)/kernel", "roi_head.score_head.pose_fcs.{1}.weight", "fc"),
    (r"score_head/pose_fc(\d)/bias", "roi_head.score_head.pose_fcs.{1}.bias", "raw"),
    (r"score_head/fused_fc(\d)/kernel", "roi_head.score_head.fused_fcs.{1}.weight", "fc"),
    (r"score_head/fused_fc(\d)/bias", "roi_head.score_head.fused_fcs.{1}.bias", "raw"),
    (r"score_head/fc_out/kernel", "roi_head.score_head.fc_out.weight", "fc"),
    (r"score_head/fc_out/bias", "roi_head.score_head.fc_out.bias", "raw"),
    (r"cov_calib_logscale", "roi_head.pose_head.cov_calib_logscale", "raw"),
)

# keys of a reference checkpoint with no serving weight behind them
_DROPPED = re.compile(
    r".*num_batches_tracked|roi_head\.projection_head\.loss_proj\.mean_inv_std"
)


def _torch_key(path: str) -> Tuple[str, str]:
    for pattern, template, kind in _RULES:
        m = re.fullmatch(pattern, path)
        if m:
            # {N} is group N as it is; {bnN} is group N as a BatchNorm
            # leaf, renamed to torch's parameter or buffer name
            bn = {f"bn{i}": _BN.get(g, g) for i, g in enumerate(m.groups(), 1)}
            return template.format(None, *m.groups(), **bn), kind
    raise KeyError(f"no reference key for JAX variable {path}")


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def from_jax_params(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) -> the port's state dict."""
    state: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _flatten(tree):
            key, kind = _torch_key(path)
            if kind == "conv":
                value = np.transpose(value, (3, 2, 0, 1))     # HWIO -> OIHW
            elif kind == "fc":
                value = np.transpose(value, (1, 0))           # (in, out) -> (out, in)
            state[key] = torch.from_numpy(np.array(value, np.float32))
    return state


def load_pth(model: nn.Module, path: str) -> nn.Module:
    """Load a reference ``.pth`` (``{"state_dict": ...}`` or a bare state
    dict) into ``model`` with ``load_state_dict`` (strict)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw)
    model.load_state_dict({k: v for k, v in sd.items() if not _DROPPED.fullmatch(k)})
    return model
