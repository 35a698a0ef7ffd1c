"""Host -> device prefetching (counterpart of `dlsg_tpu/data/prefetch.py`).

A background thread assembles the next host batches while the current step
runs. On a CUDA device it copies each batch's tensor fields into a small ring
of pinned host buffers, allocated once per slot (again only when a field's
shape or dtype changes), and from there to the device with non-blocking
copies on a side stream. A slot is refilled only after its previous copy to
the device has finished. The consumer's stream waits for the batch's copy
before the batch is handed out (`wait_event` on an event recorded after the
copy: `wait_stream` would also wait for the next batch's copy, already queued
on the side stream), and each handed-out tensor is recorded on the consumer's
stream, so the caching allocator keeps its memory until the step that reads
it has run. On the CPU the thread only turns the fields into tensors.

While a `torch.profiler` trace runs, each batch is two spans
(utils/profiler.py), both with the batch's sequence number as args:
`dlsg.data.stage` on the thread (its copy into the pinned slot and the issue
of its copy to the device) and `dlsg.data.wait` in the consumer (the wait for
the queue and for the copy). The profiler records the thread's span only
when it profiles all threads.

Close the generator when done with it (`close()`, or iterate inside
`try`/`finally`): that stops the thread and closes the host iterator. An
exception raised by the host iterator is raised again in the consumer.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from dlsg_tpu_torch.device import DeviceLike
from dlsg_tpu_torch.utils.profiler import span

BUFFER_SIZE = 2  # batches staged ahead of the consumer, and pinned slots
DEVICE_KEYS = ("frames", "regions", "captions", "lengths")  # the fields moved to the device
CAST_KEYS = ("frames", "regions")  # the float features the stage dtype applies to
_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def stage_cast(array, stage_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The `input_stage_dtype` policy: a host float batch as a tensor, cast on
    the host (before the copy to the device) when a stage dtype is set."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    return t if stage_dtype is None else t.to(stage_dtype)


def prefetch_to_device(
    batch_iter: Iterable[dict],
    device: DeviceLike,
    stage_dtype: Optional[torch.dtype] = None,
) -> Iterator[dict]:
    """Yield the batches of `batch_iter` with the fields in DEVICE_KEYS as
    tensors on `device`, up to BUFFER_SIZE batches ahead. The CAST_KEYS
    fields are cast to `stage_dtype` on the host when it is set
    (cfg.stage_dtype); other fields (video ids, valid masks) stay as they
    are."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    stop = threading.Event()
    q: "queue.Queue" = queue.Queue(maxsize=BUFFER_SIZE)
    slots = [{} for _ in range(BUFFER_SIZE)]  # pinned host buffers, per field
    copied = [None] * BUFFER_SIZE  # each slot's last copy to the device

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def to_device(batch: dict, n: int):
        slot = n % BUFFER_SIZE
        if copied[slot] is not None:
            copied[slot].synchronize()  # the slot's previous batch has left it
        staged = {}
        with torch.cuda.stream(side):
            for k in DEVICE_KEYS:
                if k not in batch:
                    continue
                src = torch.from_numpy(np.ascontiguousarray(batch[k]))
                dtype = stage_dtype if (k in CAST_KEYS and stage_dtype is not None) else src.dtype
                buf = slots[slot].get(k)
                if buf is None or buf.shape != src.shape or buf.dtype != dtype:
                    buf = slots[slot][k] = torch.empty(src.shape, dtype=dtype, pin_memory=True)
                buf.copy_(src)
                staged[k] = buf.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        copied[slot] = event
        return staged, event

    def producer() -> None:
        try:
            for n, batch in enumerate(batch_iter):
                if stop.is_set():
                    break
                with span("data.stage", n):
                    if cuda:
                        staged, event = to_device(batch, n)
                    else:
                        staged = {
                            k: stage_cast(batch[k], stage_dtype if k in CAST_KEYS else None)
                            for k in DEVICE_KEYS if k in batch
                        }
                        event = None
                    staged.update((k, v) for k, v in batch.items() if k not in staged)
                put((staged, event))
        except Exception as e:  # handed to the consumer, which raises it
            put(_Failure(e))
        finally:
            close = getattr(batch_iter, "close", None)
            if close is not None:
                close()
            put(_DONE)

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        for n in itertools.count():
            with span("data.wait", n):
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(event)
                    for k in DEVICE_KEYS:
                        if k in batch:
                            batch[k].record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join()
