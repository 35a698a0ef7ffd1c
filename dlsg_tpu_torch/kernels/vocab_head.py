"""Fused vocab head: projection + top-k + logsumexp (kernel `csrc/vocab_head.cu`).

Counterpart of `dlsg_tpu/ops/pallas/vocab_head.py::vocab_head_topk`:
`top_k(h @ w + b)` per row with h cast to w's dtype, fp32 accumulation and an
fp32 bias; values sorted descending, ties to the lowest id (as `lax.top_k`);
with `normalize` the exact row logsumexp is subtracted. On the card the
[G, V] logits never reach device memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary
from dlsg_tpu_torch.ops.topk import top_k

K_MAX = 8  # most candidates per row the kernel keeps
TILE_V = 128  # vocab columns per block; must match BN in csrc/vocab_head.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "vocab_head",
    {
        "vocab_head_topk_launch": (
            [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
            ctypes.c_int,
        ),
        **ERROR_STRING,
    },
)


def vocab_head_topk_plain(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, *, normalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: fp32 logits from the w.dtype-rounded operands,
    a stable descending sort, then `torch.logsumexp`."""
    logits = h.to(w.dtype).float() @ w.float() + b.float()[None, :]
    vals, ids = top_k(logits, k)
    if normalize:
        vals = vals - torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals, ids


def vocab_head_topk(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, *, normalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``top_k(h @ w + b)`` (+ log-softmax normalization of the winners).

    h [G, H] any float dtype (cast to w.dtype for the product), w [H, V] bf16
    or fp32, b [V]; returns (vals [G, k] fp32 descending, ids [G, k] int64).
    A CPU tensor takes `vocab_head_topk_plain`; a CUDA tensor launches the
    kernel (one tile launch and one merge launch, counted as one)."""
    if h.device.type == "cpu":
        return vocab_head_topk_plain(h, w, b, k, normalize=normalize)
    if h.device.type != "cuda":
        raise ValueError(f"vocab_head_topk runs on cuda or cpu tensors, got {h.device}")
    if h.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("expected h [G, H], w [H, V], b [V]")
    G, H = h.shape
    V = w.shape[1]
    if w.shape[0] != H or b.shape[0] != V:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not 1 <= k <= min(K_MAX, V):
        raise ValueError(f"k must be in [1, min({K_MAX}, V={V})], got {k}")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w must be bf16 or fp32, got {w.dtype}")
    if not h.is_floating_point() or not b.is_floating_point():
        raise ValueError("h and b must be float tensors")
    if {h.device, w.device, b.device} != {h.device}:
        raise ValueError("h, w and b must be on one device")
    if not (h.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("h, w and b must be contiguous")
    h32 = h.float()  # the kernel reads fp32 h and rounds it to w.dtype itself
    b32 = b.float()
    dev = h.device
    n_tiles = -(-V // TILE_V)
    part_v = torch.empty(G, n_tiles, k, device=dev, dtype=torch.float32)
    part_i = torch.empty(G, n_tiles, k, device=dev, dtype=torch.int64)
    part_m = torch.empty(G, n_tiles, device=dev, dtype=torch.float32)
    part_s = torch.empty(G, n_tiles, device=dev, dtype=torch.float32)
    vals = torch.empty(G, k, device=dev, dtype=torch.float32)
    ids = torch.empty(G, k, device=dev, dtype=torch.int64)
    if G == 0:
        return vals, ids
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.vocab_head_topk_launch(
            h32.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), b32.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), G, H, V, k, int(normalize),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        LIBRARY.launches += 1
    LIBRARY.check(err)
    return vals, ids
