"""The training step's random inputs: uniforms that follow their
generator's device, and every draw of one step on a global batch.

JAX's loop splits one key per step for the whole global batch
(``monorun_tpu/apis/train.py``), so its draws do not depend on how many
devices run the step. ``train_draws`` does the same here: every rank draws
the global batch's ``TrainDraws`` from one generator seeded alike, and
``parallel.shard_batch`` gives rank r its rows (B / N of the per-image
fields, B * max_pos / N of the per-slot ones: slots are image-major), so a
step at world N trains on the random numbers of a step at world 1 over
the same global batch.
"""

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


class TrainDraws(NamedTuple):
    """Random inputs of ``train_forward``: every field its configuration
    uses (``rcnn_noise_refined`` with ``refined_reassign``, ``noc_mask``
    with a NOC dropout), as ``train_draws`` makes them; all None, the step
    calls ``train_draws`` itself. n = B * train.max_pos positive slots."""

    rpn_noise: Optional[Tuple[Tensor, Tensor]] = None    # (B, anchors) uniforms, pos / neg
    rcnn_noise: Optional[Tuple[Tensor, Tensor]] = None   # (B, candidates) uniforms, pos / neg
    rcnn_noise_refined: Optional[Tuple[Tensor, Tensor]] = None  # refined_reassign's re-sample
    global_masks: Optional[Tuple[Tensor, Tensor, Tensor]] = None  # keep (n, C), (n, F), (n, F)
    noc_mask: Optional[Tensor] = None                    # keep (n, C), the NOC dropout2d
    ransac_keys: Optional[Tensor] = None                 # (n, hypotheses, points) uniforms
    score_uniform: Optional[Tensor] = None               # (n,) score-sampling uniforms


def uniform(shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` on ``device``, drawn on the
    generator's own device (on ``device`` when there is none): one seeded
    CPU generator gives a CPU and a GPU run the same draws."""
    src = device if generator is None else generator.device
    return torch.rand(tuple(shape), generator=generator, device=src).to(device)


def rpn_level_sizes(cfg, canvas: Tuple[int, int]):
    """(h, w) of each RPN level on a padded ``canvas``: every stride-2 layer
    of the backbone and neck rounds up, so a level of stride s is
    ceil(H / s) x ceil(W / s)."""
    H, W = canvas
    return [(math.ceil(H / s), math.ceil(W / s)) for s in cfg.rpn.anchors.strides]


def proposal_count(cfg, canvas: Tuple[int, int]) -> int:
    """``get_proposals``' output count in training: per level the top
    ``train_nms_pre``, NMS down to ``nms_post``, then the global top
    ``nms_post``."""
    a = cfg.rpn.anchors
    types = len(a.scales) * len(a.ratios)
    per_level = [min(cfg.rpn.nms_post, cfg.rpn.train_nms_pre, h * w * types)
                 for h, w in rpn_level_sizes(cfg, canvas)]
    return min(cfg.rpn.nms_post, sum(per_level))


def train_draws(cfg, batch_size: int, canvas: Tuple[int, int], num_gt: int,
                generator: Optional[torch.Generator], device) -> TrainDraws:
    """Every random draw of one training step on a batch of ``batch_size``
    images padded to ``canvas`` with ``num_gt`` GT slots each, in a fixed
    order, with the shapes ``train_forward`` needs (it calls this when it is
    handed none), drawn on the generator's own device (``uniform``): one
    seeded CPU generator gives a CPU and a GPU step the same draws, and the
    same generator state the same draws whatever the caller's rank count."""
    from ..models.global_head import train_dropout_masks

    tr, nh, a = cfg.train, cfg.noc_head, cfg.rpn.anchors
    anchors = len(a.scales) * len(a.ratios) * sum(
        h * w for h, w in rpn_level_sizes(cfg, canvas))
    n = batch_size * tr.max_pos

    def u(*shape):
        return uniform(shape, generator, device)

    def pair(m):
        return u(batch_size, m), u(batch_size, m)

    return TrainDraws(
        rpn_noise=pair(anchors),
        rcnn_noise=pair(proposal_count(cfg, canvas) + num_gt),
        rcnn_noise_refined=pair(tr.rcnn_num_samples + num_gt) if tr.refined_reassign
        else None,
        # the head reads the neck's width (models/detector.py:RoIHead)
        global_masks=train_dropout_masks(
            dataclasses.replace(cfg.global_head, in_channels=cfg.neck.out_channels),
            n, device, generator),
        noc_mask=u(n, cfg.neck.out_channels) < 1 - nh.dropout2d_rate
        if nh.dropout2d_rate > 0 else None,
        ransac_keys=u(n, cfg.pose_head.ransac_hypotheses, nh.dense_size ** 2),
        score_uniform=u(n))

