"""Gathering a distributed evaluation's results: the PyTorch counterpart of
``monorun_tpu/parallel/gather.py``.

Every rank evaluates a strided shard of the dataset (``dataset_shard``);
the per-image result dicts, fixed-shape by construction (``max_per_img``
padding), are stacked field by field and all-gathered, and every rank
reassembles the dense list in dataset order (``allgather_results``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from .mesh import rank as _rank
from .mesh import world_size


def dataset_shard(n: int, rank: Optional[int] = None,
                  world: Optional[int] = None) -> np.ndarray:
    """The strided index shard of a rank (a DistributedSampler's round
    robin without padding: the gather reassembles by index); this
    process's by default."""
    rank = _rank() if rank is None else rank
    world = world_size() if world is None else world
    return np.arange(rank, n, world)


def allgather_results(local: Dict[int, Dict[str, np.ndarray]], total: int
                      ) -> List[Optional[dict]]:
    """Every rank's ``{dataset index: result dict}`` combined into the dense
    list of length ``total`` (None where no rank had the index).

    At world size 1 a pure reassembly. Otherwise, as the JAX package does,
    each rank stacks each field of its results into one array, pads its
    count up to ``ceil(total / world)`` with zeros and marks the padding
    with index -1; the padded stacks are all-gathered
    (``all_gather_object``) and reassembled by index. A larger shard (whole
    batches, ``apis/test.py:batch_shard``) goes unpadded, an empty one as
    no fields."""
    results: List[Optional[dict]] = [None] * total
    world = world_size()
    if world == 1:
        for idx, r in local.items():
            results[idx] = r
        return results
    if total < world:
        raise ValueError(f"{total} samples over {world} ranks: every rank must own one "
                         f"(the gathered field sets must match)")
    idxs = np.asarray(sorted(local), np.int32)
    pad = max(-(-total // world) - len(idxs), 0)
    idxs_p = np.concatenate([idxs, np.full(pad, -1, np.int32)])
    first = local[int(idxs[0])] if len(idxs) else {}
    stacked = {k: np.concatenate([np.stack([local[int(i)][k] for i in idxs]),
                                  np.zeros((pad,) + first[k].shape, first[k].dtype)])
               for k in sorted(first)}
    gathered: List[Optional[tuple]] = [None] * world
    dist.all_gather_object(gathered, (idxs_p, stacked))
    for g_idx, g_fields in gathered:
        for j, idx in enumerate(g_idx):
            if int(idx) >= 0:
                results[int(idx)] = {k: v[j] for k, v in g_fields.items()}
    return results
