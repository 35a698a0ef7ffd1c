"""Device selection shared by the entry points (models, decode, serving)."""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Inside a process group (parallel/dist.py) `cuda` without an
    index is this rank's card: the one `init_distributed` made current
    (`cuda:LOCAL_RANK` unless it was given an index). Never falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and dist.is_available() and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
