"""Host-side batching.

Replaces the reference's DataLoader + DistributedSampler + collate stack
(`utils/data.py:89-147`) with a simple deterministic batcher that produces dense,
fixed-shape numpy batches. A copy of `dlsg_tpu/data/loader.py`: the same
epoch order and the same padded final eval batch.

Multi-host notes: `shard_index`/`num_shards` give each host a disjoint slice,
replacing `DistributedSampler`; every host reshuffles every epoch (the reference
had a bug where only rank 0 called `set_epoch`, run_gun.py:144-145 — fixed here,
SURVEY.md §7 'behaviors to deliberately not copy').
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def _stack_batch(dataset, idxs, use_get_batch: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """Assemble one dense batch.

    Datasets may provide `get_batch(idxs)` for single-copy batch assembly
    (CaptionDataset does — h5 `read_direct` straight into the batch array,
    one copy instead of the per-sample path's two); `use_get_batch=None`
    auto-detects it,
    False forces the per-sample path (kept for arbitrary datasets and tests).
    """
    if use_get_batch is None:
        use_get_batch = hasattr(dataset, "get_batch")
    if use_get_batch:
        return dataset.get_batch(idxs)
    samples = [dataset[int(i)] for i in idxs]
    return {k: np.stack([s[k] for s in samples], 0) for k in samples[0]}


def epoch_batch_indices(
    n: int,
    batch_size: int,
    *,
    seed: int = 12,
    epoch: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    drop_remainder: bool = True,
) -> list:
    """The epoch's batch index lists: shuffled by (seed, epoch) identically on
    every host, then a strided per-host slice — the standard multi-host SPMD
    recipe. The single source of the epoch order (the worker pool,
    `data/parallel_loader.py`, takes the same lists)."""
    order = np.random.default_rng(seed + 1000 * epoch).permutation(n)
    order = order[shard_index::num_shards]
    num_full = len(order) // batch_size
    batches = [order[b * batch_size : (b + 1) * batch_size] for b in range(num_full)]
    if len(order) % batch_size and not drop_remainder:
        batches.append(order[num_full * batch_size :])
    return batches


def train_batches(
    dataset,
    batch_size: int,
    *,
    seed: int = 12,
    epoch: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    drop_remainder: bool = True,
    use_get_batch: Optional[bool] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled, sharded training batches (see `epoch_batch_indices`)."""
    for idxs in epoch_batch_indices(
        len(dataset),
        batch_size,
        seed=seed,
        epoch=epoch,
        shard_index=shard_index,
        num_shards=num_shards,
        drop_remainder=drop_remainder,
    ):
        yield _stack_batch(dataset, idxs, use_get_batch)


def eval_batches(
    dataset,
    batch_size: int,
    *,
    shard_index: int = 0,
    num_shards: int = 1,
    pad_to_full: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential eval batches.

    The final partial batch is padded to full size by repeating the last sample
    (static shapes -> a single compiled decode fn). A boolean `valid` mask marks
    the genuine entries so scoring can drop the padding. The padded rows do get
    decoded (wasted work, bounded by one batch per eval).
    """
    idxs = np.arange(len(dataset))[shard_index::num_shards]
    for b in range(0, len(idxs), batch_size):
        chunk = idxs[b : b + batch_size]
        valid = np.ones(len(chunk), bool)
        if len(chunk) < batch_size and pad_to_full:
            pad = np.full(batch_size - len(chunk), chunk[-1])
            chunk = np.concatenate([chunk, pad])
            valid = np.concatenate([valid, np.zeros(len(pad), bool)])
        batch = _stack_batch(dataset, chunk)
        batch["valid"] = valid
        yield batch
