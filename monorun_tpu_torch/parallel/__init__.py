"""The data-parallel layer: one process per GPU on ``torch.distributed``
(``mesh.py``) and the gathering of a distributed evaluation's results
(``gather.py``); the PyTorch counterpart of ``monorun_tpu/parallel/``."""

from .gather import allgather_results, dataset_shard  # noqa: F401
from .mesh import (  # noqa: F401
    all_reduce_sum, barrier, global_mean, global_sum, init_distributed, launch_env,
    process_group, rank, replicate, shard_batch, world_size,
)
