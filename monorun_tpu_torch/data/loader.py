"""Threaded prefetching data loader (replaces torch DataLoader workers).

The reference uses torch DataLoader with 3 worker processes per GPU
(configs/kitti_multiclass.py:254-255). Here a thread pool decodes and
augments on the host while the device computes, with a bounded prefetch
queue; batches are numpy, and the caller copies them to its device.

The port's copy of ``monorun_tpu/data/loader.py``, with one repair: an
exception raised while a batch is prepared is passed through the queue
and raised again in the consumer (in the JAX package's loader it ends the
worker thread, and the consumer then waits on the queue for ever).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..config import DataConfig
from .kitti import KITTI3DDataset
from .pipeline import collate, prepare_test_sample, prepare_train_sample


class _WorkerError:
    """An exception of the worker thread, on its way to the consumer."""

    def __init__(self, error: Exception):
        self.error = error


class PrefetchLoader:
    def __init__(
        self,
        ds: KITTI3DDataset,
        data_cfg: DataConfig,
        batch_size: int,
        train: bool = True,
        seed: int = 0,
        shuffle: Optional[bool] = None,
        prefetch: int = 4,
        max_pts: int = 512,
        drop_last: Optional[bool] = None,
        indices: Optional[np.ndarray] = None,
    ):
        """``indices`` restricts iteration to a subset of the dataset —
        the per-process shard in distributed eval (reference:
        DistributedSampler in mmcv's build_dataloader)."""
        self.ds = ds
        self.indices = (
            None if indices is None else np.asarray(indices, np.int64)
        )
        self.data_cfg = data_cfg
        self.batch_size = batch_size
        self.train = train
        self.shuffle = train if shuffle is None else shuffle
        self.drop_last = train if drop_last is None else drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.max_pts = max_pts
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.ds) if self.indices is None else len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self) -> np.ndarray:
        idx = (np.arange(len(self.ds)) if self.indices is None
               else self.indices.copy())
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        order = self._index_order()
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                produce()
            except Exception as e:  # raised again in the consumer
                q.put(_WorkerError(e))

        def produce():
            rng = np.random.default_rng(
                (self.seed + 1) * 100003 + self.epoch
            )
            for b in range(n_batches):
                if stop.is_set():
                    return
                ids = order[b * self.batch_size : (b + 1) * self.batch_size]
                # pad the last partial batch by wrapping (eval handles
                # duplicates by slicing to len(ds))
                if len(ids) < self.batch_size:
                    ids = np.concatenate(
                        [ids, order[: self.batch_size - len(ids)]]
                    )
                if self.train:
                    samples = [
                        prepare_train_sample(
                            self.ds, int(i), self.data_cfg, rng,
                            max_pts=self.max_pts,
                        )
                        for i in ids
                    ]
                else:
                    samples = [
                        prepare_test_sample(self.ds, int(i), self.data_cfg)
                        for i in ids
                    ]
                batch = collate(samples)
                batch["_indices"] = np.asarray(ids)
                q.put(batch)
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, _WorkerError):
                    raise item.error
                yield item
        finally:
            stop.set()
        self.epoch += 1
