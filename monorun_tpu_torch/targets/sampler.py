"""Random positive/negative sampling, fixed-shape (mmdet RandomSampler
semantics), the PyTorch counterpart of ``monorun_tpu/targets/sampler.py``.

The output layout is static: ``max_pos`` positive slots then ``num -
max_pos`` negative slots, each with a validity flag. A uniform random
subset is the top k of uniform noise over the eligible items (the others
score -1); the noise is an input, so the port and the JAX package can
take the same draws. Ties resolve to the lower index, as
``jax.lax.top_k`` does. One image per call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.rpn import _topk_stable
from .assigner import ASSIGN_NEG

Tensor = torch.Tensor


class SampleResult(NamedTuple):
    pos_inds: Tensor       # (max_pos,) candidate indices
    pos_valid: Tensor      # (max_pos,) bool
    pos_boxes: Tensor      # (max_pos, 4)
    pos_gt_inds: Tensor    # (max_pos,) matched GT index (clipped >= 0)
    pos_labels: Tensor     # (max_pos,) GT class
    neg_inds: Tensor       # (num_neg,)
    neg_valid: Tensor      # (num_neg,)
    neg_boxes: Tensor      # (num_neg, 4)


def _random_topk(noise: Tensor, eligible: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    score = torch.where(eligible, noise, torch.full_like(noise, -1.0))
    vals, idx = _topk_stable(score, k)
    return idx, vals >= 0.0


def sample_rois(
    noise: Tuple[Tensor, Tensor],   # (n,) uniforms for the positives, negatives
    boxes: Tensor,          # (n, 4) candidates (proposals [+ GTs])
    assigned_gt: Tensor,    # (n,) assignment codes
    labels: Tensor,         # (n,) class of the matched GT
    num: int,
    pos_fraction: float,
    max_pos: Optional[int] = None,
) -> SampleResult:
    if max_pos is None:
        max_pos = int(num * pos_fraction)
    num_neg = num - max_pos
    pos_inds, pos_valid = _random_topk(noise[0], assigned_gt >= 0, max_pos)
    neg_inds, neg_valid = _random_topk(noise[1], assigned_gt == ASSIGN_NEG, num_neg)
    return SampleResult(
        pos_inds=pos_inds,
        pos_valid=pos_valid,
        pos_boxes=boxes[pos_inds],
        pos_gt_inds=assigned_gt[pos_inds].clamp(min=0),
        pos_labels=labels[pos_inds].clamp(min=0),
        neg_inds=neg_inds,
        neg_valid=neg_valid,
        neg_boxes=boxes[neg_inds],
    )
