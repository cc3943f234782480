"""One process per GPU on ``torch.distributed``: the PyTorch counterpart of
``monorun_tpu/parallel/mesh.py`` (``make_mesh``, ``shard_batch``,
``replicate``).

JAX lays a 1-D ``data`` mesh over the devices, shards the global batch over
it (``NamedSharding(P('data'))``), replicates the train state, and compiles
one program over the global batch: every reduction across samples in the
step, and the gradient's, is a reduction over the global batch. The port
runs one process (a rank) per GPU, as the reference's DDP launch did
(``python -m torch.distributed.run --nproc-per-node N``): a rank holds the
whole model and its contiguous rows of the global batch (``shard_batch``).
What JAX's program reduces over the batch, the step reduces over the ranks:
the denominators of the losses and the batch statistics through
``global_sum`` and ``global_mean``, the gradient and the logged losses
through ``all_reduce_sum`` (``train.py:train_step``).

At world size 1 (no process group) every function here is the identity,
and the step computes exactly what it computes without this layer.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT")


def world_size() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def launch_env() -> Dict[str, str]:
    """The variables ``torch.distributed.run`` (torchrun) gives each
    process; raises when one is missing (the process was not launched by
    it)."""
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs the environment torch.distributed.run gives each "
            f"process ({', '.join(missing)} not set): launch with "
            f"python -m torch.distributed.run --nproc-per-node N -m <module> ... "
            f"--distributed")
    return {k: os.environ[k] for k in LAUNCH_ENV}


def init_distributed(backend: str | None = None,
                     device: str | torch.device = "cuda") -> torch.device:
    """Joins the process group torchrun's environment describes and
    returns this rank's device: for ``device="cuda"`` the GPU
    ``LOCAL_RANK`` (made current), for an explicit ``cuda:i`` that GPU (two
    ranks may share one card then, over Gloo), for ``"cpu"`` the CPU. The
    backend defaults to NCCL on a GPU and Gloo on the CPU; NCCL refuses two
    ranks on one device."""
    from ..apis.inference import resolve_device

    env = launch_env()
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method="env://", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return device


@contextlib.contextmanager
def process_group(backend: str | None = None,
                  device: str | torch.device = "cuda") -> Iterator[torch.device]:
    """``init_distributed`` for the body of a ``with``, the group destroyed
    at its end."""
    device = init_distributed(backend, device)
    try:
        yield device
    finally:
        dist.destroy_process_group()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shard_batch(batch, rank: int, world: int):
    """This rank's contiguous rows of every leaf of a global batch (dicts,
    tuples, named tuples and None are walked; arrays and tensors sliced
    along their first axis): what ``NamedSharding(P('data'))`` gives a
    device. The leading axis must divide by ``world``."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, tuple):
        parts = [shard_batch(v, rank, world) for v in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else tuple(parts)
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"a leading axis of {n} rows does not divide over {world} ranks")
    per = n // world
    return batch[rank * per:(rank + 1) * per]


@torch.no_grad()
def replicate(model: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers, broadcast to every rank in place."""
    if world_size() > 1:
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


def global_sum(t: Tensor) -> Tensor:
    """``t`` summed over the ranks; ``t`` itself at world size 1.

    For counts and statistics that carry no gradient: every batch-wide
    quantity of the training step is one (JAX takes them under
    ``stop_gradient`` or from values without gradient). A tensor that
    requires grad raises, since this sum would cut its gradient: a
    batch-wide quantity that JAX differentiates through would need an
    all-reduce whose backward all-reduces the incoming gradient."""
    if world_size() == 1:
        return t
    if t.requires_grad:
        raise ValueError("global_sum of a tensor that requires grad would drop the "
                         "gradient through the other ranks' rows")
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_mean(t: Tensor) -> Tensor:
    """The mean of ``t``'s elements over every rank (``t.mean()`` at world
    size 1), for tensors without gradient, as ``global_sum``."""
    if world_size() == 1:
        return t.mean()
    total = global_sum(torch.stack([t.sum(), torch.tensor(float(t.numel()), dtype=t.dtype,
                                                          device=t.device)]))
    return total[0] / total[1]


def all_reduce_sum(tensors: Sequence[Tensor]) -> List[Tensor]:
    """Every tensor summed over the ranks (the inputs at world size 1): one
    flat all-reduce per dtype and device. The step's gradient and its
    logged losses, each rank's share of the global value, go through it."""
    tensors = list(tensors)
    if world_size() == 1:
        return tensors
    out: List[Tensor] = list(tensors)
    buckets: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out
