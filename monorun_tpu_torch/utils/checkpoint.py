"""Training checkpoints: the counterpart of the save, load and
``latest_checkpoint`` half of ``monorun_tpu/utils/checkpoint.py`` (which
uses orbax). The reference ``.pth`` converter is ``utils/weights.py``.

A checkpoint is the directory ``workdir/step_{step}`` (JAX's name) holding
one ``torch.save`` file: the model's ``state_dict`` (parameters and
buffers, the score head's running statistics included), the optimizer's
state (``AdamW.state_dict``) and the train state (``step``, ``loss_ema``).
Every tensor is copied to the host before it is written, so a checkpoint
made on the GPU loads on the CPU and the reverse.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
from torch import nn

from ..train import AdamW, TrainState

FILE = "checkpoint.pt"


def save_checkpoint(workdir: str, model: nn.Module, optimizer: AdamW, state: TrainState,
                    step: int) -> str:
    """Writes ``workdir/step_{step}`` (replacing one of the same step) and
    returns its path."""
    target = os.path.join(os.path.abspath(workdir), f"step_{step}")
    os.makedirs(target, exist_ok=True)
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "train_state": state.to_dict(),
    }
    tmp = os.path.join(target, FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(target, FILE))
    return target


def load_checkpoint(path: str, model: nn.Module, optimizer: Optional[AdamW] = None
                    ) -> TrainState:
    """Restores a checkpoint directory into ``model`` (and ``optimizer``,
    when given) in place, on their devices; returns its train state. A
    missing checkpoint raises ``FileNotFoundError``."""
    file = os.path.join(path, FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint at {path}")
    payload = torch.load(file, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    device = next(model.parameters()).device
    return TrainState.from_dict(payload["train_state"], device)


def latest_checkpoint(workdir: str) -> str | None:
    """The ``step_N`` entry of ``workdir`` with the largest N, or None."""
    if not os.path.isdir(workdir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(workdir)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    if not steps:
        return None
    return os.path.join(workdir, f"step_{max(steps)}")
