"""Exact top-k with `lax.top_k`'s order: values descending, ties broken by the
lowest index. `torch.topk` promises no tie order, so this sorts stably."""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [..., k], indices [..., k] int64) of the last axis."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]
