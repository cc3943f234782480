"""Training loop: epochs, logging, checkpoints, periodic validation; the
PyTorch counterpart of ``monorun_tpu/apis/train.py`` (``MetricLogger``,
``train_detector``, ``_run_val``).

Data-parallel over the ranks of a process group (``parallel/``; world
size 1 without one): the global batch is ``samples_per_device`` x world,
as JAX's is over its mesh. Every rank runs the same seeded loader over the
global batch and keeps its own rows (``shard_batch``), as each JAX process
takes its rows of one global array, so the augmentation draws are JAX's;
each rank decodes the whole global batch. Rank 0 alone writes
``train_log.jsonl``, ``grad_stats.jsonl`` and the checkpoints, the others
waiting at a barrier: JAX's processes each write on their own host, and
ranks on one host would write the same files. Every rank runs the
validation, each detecting its share of its batches (``run_eval`` with
``distributed`` and ``whole_batches``), and every rank evaluates the
gathered results: the AP of a world-1 run on the same weights, as JAX's
processes each evaluate the whole set; rank 0 alone logs it. Each
batch goes to the device in one pinned, non-blocking copy per array;
metrics come to the host only at the log interval.

The JAX loop's resume flaws are kept, so the two packages train alike:
after a resume the random draws restart from ``seed + 1`` and the loader's
epoch from 0, so the shuffle order and the augmentation draws restart too.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from ..config import MonoRUnConfig
from ..data.kitti import KITTI3DDataset
from ..data.loader import PrefetchLoader
from ..models.detector import MonoRUn
from ..parallel import barrier, rank, replicate, shard_batch, world_size
from ..train import TrainState, create_train_state, train_step
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.draws import train_draws
from .inference import InferenceSession, load_weights, resolve_device, upload
from .test import run_eval


class MetricLogger:
    """Text + JSONL + TensorBoard metric logging, as the JAX package's.

    ``train_log.jsonl`` gets one record per logged step: each metric
    rounded to 5 decimals (in sorted key order, as JAX's jitted step
    returns them), then ``step``, ``epoch`` and ``wall`` (seconds since
    the logger started). The TensorBoard writer is optional: event files
    land in workdir/tb/ when ``torch.utils.tensorboard`` imports,
    otherwise logging degrades to text and JSONL with a one-time notice.
    """

    def __init__(self, workdir: str, interval: int = 10, tensorboard: bool = True):
        self.interval = interval
        self.path = os.path.join(workdir, "train_log.jsonl")
        os.makedirs(workdir, exist_ok=True)
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(workdir, "tb"))
            except Exception as e:  # the package is optional
                print(f"[logger] tensorboard disabled ({e})", flush=True)

    def log(self, step: int, epoch: int, metrics: Dict[str, torch.Tensor]):
        if step % self.interval:
            return
        rec = {k: round(v, 5) for k, v in to_host(metrics).items()}
        rec.update(step=step, epoch=epoch, wall=round(time.time() - self._t0, 1))
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "epoch"):
                    self._tb.add_scalar(f"train/{k}", v, step)
        msg = " ".join(f"{k}={rec[k]:.4f}" for k in sorted(rec) if k.startswith("loss"))
        print(f"[e{epoch} it{step}] total={rec.get('total_loss', 0):.4f} "
              f"{msg} iou={rec.get('mean_iou', 0):.3f}", flush=True)

    def log_eval(self, step: int, ap: Dict[str, float]):
        """Scalar AP metrics of a periodic validation."""
        if self._tb is not None and ap:
            for k, v in ap.items():
                self._tb.add_scalar(f"val/{k}", float(v), step)

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()


def to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar metrics as Python floats, in sorted key order, in one copy
    from their device."""
    keys = sorted(metrics)
    values = torch.stack([torch.as_tensor(metrics[k]).float() for k in keys]).cpu()
    return dict(zip(keys, values.tolist()))


def train_detector(
    cfg: MonoRUnConfig,
    workdir: str,
    resume_from: Optional[str] = None,
    load_from: Optional[str] = None,
    max_steps: Optional[int] = None,
    val_ds: Optional[KITTI3DDataset] = None,
    device: str | torch.device = "cuda",
) -> Tuple[MonoRUn, TrainState]:
    """Full training run. Returns the trained model and its final train
    state (JAX's final ``TrainState`` holds both).

    ``load_from`` takes a reference ``.pth`` or a port checkpoint (its
    weights); ``resume_from`` a port checkpoint (weights, optimizer and
    train state), and without it the newest ``step_N`` of ``workdir`` is
    resumed. A checkpoint is written every ``train.checkpoint_interval``
    epochs and at the end; ``val_ds`` is evaluated every
    ``train.eval_interval`` epochs. In a process group each rank passes its
    own device. Each step's random draws are the global batch's, from one
    generator seeded ``seed + 1`` on every rank (JAX's ``PRNGKey(seed +
    1)``), and rank r takes its rows of them: a run trains on the same
    random numbers at every world size."""
    device = resolve_device(device)
    tr = cfg.train
    ds = KITTI3DDataset(cfg.data.train_root, cfg.data.train_list, classes=cfg.data.classes,
                        coord_3d_prefix=cfg.data.coord_3d_prefix)
    world, me = world_size(), rank()
    lead = me == 0
    global_batch = tr.samples_per_device * world
    loader = PrefetchLoader(ds, cfg.data, global_batch, train=True, seed=tr.seed)
    steps_per_epoch = len(loader)
    total_steps = steps_per_epoch * tr.total_epochs
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)

    model, state, optimizer = create_train_state(cfg, total_steps, device=device,
                                                 seed=tr.seed)
    if load_from:
        load_weights(model, load_from)
    resume_from = resume_from or latest_checkpoint(workdir)
    if resume_from:
        state = load_checkpoint(resume_from, model, optimizer)
    replicate(model)

    step = state.step
    logger = MetricLogger(workdir, tr.log_interval, tensorboard=tr.tensorboard) if lead \
        else None
    generator = torch.Generator(device=device).manual_seed(tr.seed + 1)

    epoch = step // max(steps_per_epoch, 1)
    while step < total_steps:
        for batch in loader:
            batch.pop("_indices")
            draws = train_draws(cfg, len(batch["images"]), batch["images"].shape[1:3],
                                batch["gt_boxes"].shape[1], generator, device)
            batch = {k: upload(v, device) for k, v in shard_batch(batch, me, world).items()}
            # train_step runs the step at apply_loss_schedule(cfg, state.step),
            # the config JAX's loop re-specialises its step to at each boundary
            state, metrics = train_step(
                model, optimizer, state, batch, shard_batch(draws, me, world),
                generator=generator,
                with_grad_stats=tr.log_grad_stats,
                with_param_stats=tr.save_stats_interval > 0)
            step += 1
            pstats = metrics.pop("param_stats", None)
            if lead:
                if pstats is not None and tr.save_stats_interval \
                        and step % tr.save_stats_interval == 0:
                    with open(os.path.join(workdir, "grad_stats.jsonl"), "a") as f:
                        f.write(json.dumps({"step": step, **to_host(pstats)}) + "\n")
                logger.log(step, epoch, metrics)
            if max_steps is not None and step >= max_steps:
                break
        epoch += 1
        if tr.checkpoint_interval and epoch % tr.checkpoint_interval == 0:
            if lead:
                save_checkpoint(workdir, model, optimizer, state, step)
            barrier()
        if val_ds is not None and tr.eval_interval and epoch % tr.eval_interval == 0:
            ap = _run_val(cfg, model, val_ds)
            if lead:
                logger.log_eval(step, ap)
        if max_steps is not None and step >= max_steps:
            break

    if lead:
        save_checkpoint(workdir, model, optimizer, state, step)
        logger.close()
    barrier()
    return model, state


def _run_val(cfg: MonoRUnConfig, model: MonoRUn, val_ds: KITTI3DDataset):
    """``run_eval`` at batch 2 on the training weights. The session serves
    a copy: it casts the weights to the compute dtype in place and sets
    eval mode, which the training model must not see. It is not warmed:
    the loop has already built and loaded the kernels, so a warm-up would
    only add a forward to every validation (JAX's ``_run_val`` takes the
    warm default, whose compile its persistent cache makes cheap after the
    first time). In a process group each rank detects its share of the
    batches and every rank returns the AP of the whole set; rank 0 alone
    prints it."""
    device = next(model.parameters()).device
    session = InferenceSession(cfg, copy.deepcopy(model), 2, device, warm=False)
    return run_eval(session, val_ds, batch_size=2, print_summary=True,
                    distributed=world_size() > 1, whole_batches=True)
