"""Named stages of the serving forward (``MonoRUn.serve_raw`` ->
``heads_forward``), the names of ``tools/profile_stages.py``'s ladder.

A model marks a stage's code with ``with model.stage(name):``. Unless a
timer is installed on that model with ``timing(model, hook)`` the mark is
one shared null context, so an unprofiled forward pays an attribute read
per stage. ``hook(name)`` returns the context a stage runs under: a
``torch.profiler.record_function`` range (``tools/profile_trace.py``) or
the ladder's synchronised timer (``tools/profile_stages.py``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Iterator

# in the order a forward runs them; together they cover the whole forward
STAGES = (
    "preprocess",        # the uint8 canvas resized, normalised and padded
    "backbone_fpn",      # ResNet + FPNplus
    "rpn_proposals",     # RPN head, proposal decode and NMS
    "align_proposals",   # the 7x7 align of every proposal
    "bbox_head_nms",     # bbox head, multiclass NMS, the head slots
    "global_head_mc",    # the detections' 7x7 align, the MC global head, dims
    "noc_head",          # the 14x14 align, the NOC head and its decoders
    "pnp",               # uncertainty PnP and the covariance calibration
    "score_3d_nms",      # score head, 3D NMS, the fixed-shape outputs
)

NULL = contextlib.nullcontext()


@contextlib.contextmanager
def timing(model, hook: Callable[[str], ContextManager]) -> Iterator[None]:
    """Every stage of ``model`` runs under ``hook(name)`` inside the block."""
    saved, model.stage_hook = model.stage_hook, hook
    try:
        yield
    finally:
        model.stage_hook = saved
