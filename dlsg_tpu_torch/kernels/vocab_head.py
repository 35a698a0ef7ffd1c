"""Fused vocab head: projection + top-k + logsumexp (kernel `csrc/vocab_head.cu`).

Counterpart of `dlsg_tpu/ops/pallas/vocab_head.py::vocab_head_topk`:
`top_k(h @ w + b)` per row with h cast to w's dtype, fp32 accumulation and an
fp32 bias; values sorted descending, ties to the lowest id (as `lax.top_k`);
with `normalize` the exact row logsumexp is subtracted, and with `return_lse`
it is returned as well (a head split over ranks merges the ranks' top-k and
logsumexp, evaluation/decode.py). On the card the [G, V] logits never reach
device memory.

The dtype of w alone picks the kernel's tile form, both on the tensor cores:
bf16 w runs one bf16 product (h rounded to bf16 once, here), fp32 w three TF32
products of a hi/lo split of h and w that keep fp32 accuracy (route
"tf32x3"). `vocab_head_plan` gives each form's tiles, grid and shared memory.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple, Union

import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary
from dlsg_tpu_torch.ops.topk import top_k

K_MAX = 8  # most candidates per row the kernel keeps
TILE_V = 128  # vocab columns per block, both forms; must match BN in csrc/vocab_head.cu
THREADS = 256  # per tile block, both forms

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "vocab_head",
    {
        "vocab_head_topk_launch": (
            [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
            ctypes.c_int,
        ),
        "vocab_head_tc_smem_bytes": ([], ctypes.c_int),
        "vocab_head_tf32x3_smem_bytes": ([], ctypes.c_int),
        **ERROR_STRING,
    },
)
# launches of each tile form; each also counts in LIBRARY.launches
ROUTE_LAUNCHES = {"tensor_cores": 0, "tf32x3": 0}


@dataclass(frozen=True)
class TilePlan:
    """One tile form of the kernel: [block_m x block_k] h and [block_k x
    TILE_V] w tiles through `stages` shared-memory stages, a grid of
    `grid` blocks of THREADS threads, `smem_bytes` of shared memory each."""

    route: str
    block_m: int
    block_k: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int


def vocab_head_plan(G: int, V: int, w_dtype: torch.dtype) -> TilePlan:
    """The tile form for w of `w_dtype` (as the constants of
    csrc/vocab_head.cu). Both are 128 x 128 tiles on a (row tiles, vocab
    tiles) grid, a 4-stage ring of [128 x 32] h and [32 x 128] w tiles reused
    as the [128 x 130] fp32 logits tile (rows padded by the THREADS / 128
    threads that share a row in the epilogue). bf16 -> route "tensor_cores",
    bf16 rings with rows padded by 8 bf16 against bank conflicts; fp32 ->
    route "tf32x3", fp32 rings with h rows padded by 4 floats and w rows by 8."""
    bm, bk, stages = 128, 32, 4
    if w_dtype == torch.bfloat16:
        route, a_pad, b_pad, size = "tensor_cores", 8, 8, 2
    elif w_dtype == torch.float32:
        route, a_pad, b_pad, size = "tf32x3", 4, 8, 4
    else:
        raise ValueError(f"w must be bf16 or fp32, got {w_dtype}")
    ring = stages * (bm * (bk + a_pad) + bk * (TILE_V + b_pad)) * size
    return TilePlan(route, bm, bk, stages, (-(-G // bm), -(-V // TILE_V)),
                    max(ring, bm * (TILE_V + THREADS // bm) * 4))


TopK = Union[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def vocab_head_topk_plain(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, *, normalize: bool = True,
    return_lse: bool = False,
) -> TopK:
    """Plain PyTorch version: fp32 logits from the w.dtype-rounded operands,
    a stable descending sort, then `torch.logsumexp`."""
    logits = h.to(w.dtype).float() @ w.float() + b.float()[None, :]
    vals, ids = top_k(logits, k)
    if not (normalize or return_lse):
        return vals, ids
    lse = torch.logsumexp(logits, dim=-1)
    if normalize:
        vals = vals - lse[:, None]
    return (vals, ids, lse) if return_lse else (vals, ids)


def vocab_head_topk(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, *, normalize: bool = True,
    return_lse: bool = False,
) -> TopK:
    """Fused ``top_k(h @ w + b)`` (+ log-softmax normalization of the winners).

    h [G, H] any float dtype (cast to w.dtype for the product), w [H, V] bf16
    or fp32, b [V]; returns (vals [G, k] fp32 descending, ids [G, k] int64),
    and with `return_lse` also the row logsumexp lse [G] fp32.
    A CPU tensor takes `vocab_head_topk_plain`; a CUDA tensor launches the
    kernel (one tile launch and one merge launch, counted as one): with bf16 w
    the bf16 tensor-core tiles, with fp32 w the TF32x3 tiles. The merge
    launch writes the lse when it is asked for."""
    if h.device.type == "cpu":
        return vocab_head_topk_plain(h, w, b, k, normalize=normalize, return_lse=return_lse)
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
    if not h.is_floating_point() or not b.is_floating_point():
        raise ValueError("h and b must be float tensors")
    if {h.device, w.device, b.device} != {h.device}:
        raise ValueError("h, w and b must be on one device")
    if not (h.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("h, w and b must be contiguous")
    plan = vocab_head_plan(G, V, w.dtype)
    hk = h.to(w.dtype)  # as the TPU kernel's h.astype(w.dtype); no copy if h is w.dtype
    b32 = b.float()
    dev = h.device
    n_tiles = -(-V // TILE_V)
    part_v = torch.empty(G, n_tiles, k, device=dev, dtype=torch.float32)
    part_i = torch.empty(G, n_tiles, k, device=dev, dtype=torch.int64)
    part_m = torch.empty(G, n_tiles, device=dev, dtype=torch.float32)
    part_s = torch.empty(G, n_tiles, device=dev, dtype=torch.float32)
    vals = torch.empty(G, k, device=dev, dtype=torch.float32)
    ids = torch.empty(G, k, device=dev, dtype=torch.int64)
    lse = torch.empty(G, device=dev, dtype=torch.float32) if return_lse else None
    out = (vals, ids, lse) if return_lse else (vals, ids)
    if G == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.vocab_head_topk_launch(
            hk.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), b32.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), G, H, V, k, int(normalize),
            torch.cuda.current_stream(dev).cuda_stream,
            None if lse is None else lse.data_ptr(),
        )
        LIBRARY.launches += 1
        ROUTE_LAUNCHES[plan.route] += 1
    LIBRARY.check(err)
    return out
