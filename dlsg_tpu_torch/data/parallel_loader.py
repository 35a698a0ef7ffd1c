"""Process-parallel training batch assembly (counterpart of
`dlsg_tpu/data/parallel_loader.py`; the reference feeds its GPUs from 4
DataLoader workers, utils/data.py:115-130).

HDF5 serializes every call within a process (h5py holds its own lock on
top), so reads scale with processes, not threads. `WorkerPool` is a
`torch.utils.data.DataLoader` whose items are whole batches:

- its sampler yields the epoch's batch index lists
  (`loader.epoch_batch_indices`), so the batches are those of
  `loader.train_batches` with the same arguments, bitwise, in the same
  order;
- a worker is a spawned process (no fork of live CUDA or HDF5 state) that
  rebuilds the dataset from `dataset.spawn_spec()` on its first batch, with
  its own file handles, and reads each batch with the dataset's
  single-copy `get_batch`. Its arrays cross to the parent as tensors in
  shared memory, not through a pipe;
- the workers persist across epochs, and each holds at most
  PREFETCH_FACTOR batches in flight. An epoch left mid-way thus leaves at
  most `num_workers * PREFETCH_FACTOR` batches queued: the next epoch's
  first batch waits for those (the DataLoader's reset of persistent
  workers), and `close()` makes the workers skip them.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from dlsg_tpu_torch.data.loader import epoch_batch_indices

# batches in flight per worker: one being read, one ready (at MSR-VTT scale
# ~1 GB of shared memory each)
PREFETCH_FACTOR = 2


class _EpochSampler:
    """The current epoch's batch index lists (set by the parent before each
    epoch; the DataLoader reads it in the parent only)."""

    def __init__(self):
        self.batches: List[List[int]] = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


class _BatchReader(Dataset):
    """Item = one batch, key = its index list. Pickled to each worker as its
    spec alone; the dataset is rebuilt there on first use."""

    def __init__(self, spec):
        self.spec = spec
        self._dataset = None

    def __getitem__(self, idxs) -> Dict[str, np.ndarray]:
        if self._dataset is None:
            cls, args = self.spec
            self._dataset = cls(*args)
        return self._dataset.get_batch(np.asarray(idxs, np.int64))


def _as_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Run in the worker: tensors are sent to the parent through shared
    memory."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


class WorkerPool:
    """Training batches from `num_workers` spawned processes (module doc).

    `dataset` needs `spawn_spec()`, `get_batch(idxs)` and `__len__`
    (CaptionDataset, EvalVideoDataset). Workers start at the first
    `epoch_batches` call. Read one epoch at a time, then `close()` (or use
    the pool as a context manager)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 2):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._n = len(dataset)
        self._batch_size = batch_size
        self._sampler = _EpochSampler()
        self._loader = DataLoader(
            _BatchReader(dataset.spawn_spec()),
            sampler=self._sampler,
            batch_size=None,  # an item is already a batch
            collate_fn=_as_tensors,
            num_workers=num_workers,
            multiprocessing_context="spawn",
            persistent_workers=True,
            prefetch_factor=PREFETCH_FACTOR,
        )
        self._closed = False

    def epoch_batches(
        self,
        *,
        seed: int = 12,
        epoch: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        drop_remainder: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches: `loader.train_batches(dataset, ...)` with the
        same arguments, as numpy arrays."""
        if self._closed:
            raise RuntimeError("the worker pool is closed")
        self._sampler.batches = [
            [int(i) for i in b]
            for b in epoch_batch_indices(
                self._n, self._batch_size, seed=seed, epoch=epoch, shard_index=shard_index,
                num_shards=num_shards, drop_remainder=drop_remainder,
            )
        ]
        batches = iter(self._loader)  # now, not at the first next(): the sampler is read here
        return ({k: v.numpy() for k, v in b.items()} for b in batches)

    def close(self) -> None:
        """Stop the workers (a batch being read is finished, queued ones are
        skipped)."""
        if self._closed:
            return
        self._closed = True
        it = getattr(self._loader, "_iterator", None)
        if it is not None:
            it._shutdown_workers()
            self._loader._iterator = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
