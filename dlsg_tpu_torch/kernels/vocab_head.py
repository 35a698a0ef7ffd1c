"""Fused vocab head: projection + top-k + logsumexp (kernel `csrc/vocab_head.cu`).

Counterpart of `dlsg_tpu/ops/pallas/vocab_head.py::vocab_head_topk`:
`top_k(h @ w + b)` per row with h cast to w's dtype, fp32 accumulation and an
fp32 bias; values sorted descending, ties to the lowest id (as `lax.top_k`);
with `normalize` the exact row logsumexp is subtracted, and with `return_lse`
it is returned as well (a head split over ranks merges the ranks' top-k and
logsumexp, evaluation/decode.py). On the card the [G, V] logits never reach
device memory.

`vocab_head_plan` picks the kernel's route from w's dtype, both on the
tensor cores: bf16 w takes the persistent TMA + `wgmma` kernel (route
"wgmma"; one bf16 product, h rounded to bf16 once, here), fp32 w three TF32
products of a hi/lo split of h and w that keep fp32 accuracy (route
"tf32x3"). The plan gives each route's tiles, blocks and shared memory.

TMA reads rows whose pitch is a multiple of 16 bytes from a 16-byte aligned
base. `aligned_rows` lays a bf16 w out so, in rows of ceil8(V), once per
decode (`Decoder.vocab_head_weights`); the wrapper lays out h so on every
call where it is not (H not a multiple of 8), and a w given otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary, cached, sm_count
from dlsg_tpu_torch.kernels.lstm_scan import N_SM
from dlsg_tpu_torch.ops.topk import top_k

K_MAX = 8  # most candidates per row the kernel keeps
TILE_V = 128  # vocab columns per block of the fp32 tile kernel; BN in csrc/vocab_head.cu
THREADS = 256  # per block of the fp32 tile kernel
# The persistent kernel (route "wgmma"; W_* in csrc/vocab_head.cu): 128 rows a
# tile (two consumer warpgroups of 64), 64 k a ring stage (128 bytes of bf16),
# tile widths of 128 or 64 columns, a 192 KB ring of at most 8 stages, each
# warpgroup's bias tile, the barriers and 1 KB to align the ring.
WGMMA_BLOCK_M, WGMMA_BLOCK_K = 128, 64
WGMMA_BLOCK_NS = (128, 64)  # the widths the kernel is built for, widest first
WGMMA_RING_BYTES, WGMMA_MAX_STAGES = 196_608, 8
WGMMA_SMEM_FIXED = 1024 + 2 * 128 * 4 + 2 * WGMMA_MAX_STAGES * 8
TMA_ALIGN = 16  # bytes: a TMA map's base and row pitch are multiples of it
CACHE_SIZE = 64  # w maps kept (least recently used out)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary(
    "vocab_head",
    {
        "vocab_head_topk_launch": (
            [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _L],
            ctypes.c_int,
        ),
        "vocab_head_tf32x3_smem_bytes": ([], ctypes.c_int),
        "vocab_head_wgmma_smem_bytes": ([_I], ctypes.c_int),
        "vocab_head_map_bytes": ([], ctypes.c_int),
        "vocab_head_encode_map": ([_P, _P, _I, _I, _L], ctypes.c_int),
        **ERROR_STRING,
    },
)
# launches of each route; each also counts in LIBRARY.launches
ROUTE_LAUNCHES = {"wgmma": 0, "tf32x3": 0}
# TMA maps of bf16 w by (pointer, H, V, row pitch): bytes the launch copies
WEIGHT_MAPS: "OrderedDict[Tuple[int, int, int, int], ctypes.Array]" = OrderedDict()


@dataclass(frozen=True)
class TilePlan:
    """One route of the kernel: output tiles of block_m x block_n (row tiles
    x vocab tiles in `tiles`), [block_m x block_k] h and [block_k x block_n]
    w tiles through `stages` shared-memory stages, `blocks` blocks of
    `smem_bytes` shared memory each. The tile kernel launches one block a
    tile; the persistent kernel at most one a SM, block b walking tiles b, b
    + blocks, ... with the row tile the fast index."""

    route: str
    block_m: int
    block_n: int
    block_k: int
    stages: int
    tiles: Tuple[int, int]
    blocks: int
    smem_bytes: int


def _wgmma_plan(G: int, V: int, bn: int, n_sm: int) -> TilePlan:
    """The persistent kernel's plan at tile width `bn` (one of
    WGMMA_BLOCK_NS): 128 x bn tiles, the deepest ring of [128 x 64] h +
    [64 x bn] w bf16 stages that fits, at most one block per SM. The
    breakdown forces its widths through it."""
    if bn not in WGMMA_BLOCK_NS:
        raise ValueError(f"the tile width must be one of {WGMMA_BLOCK_NS}, got {bn}")
    stage = (WGMMA_BLOCK_M + bn) * WGMMA_BLOCK_K * 2
    stages = min(WGMMA_MAX_STAGES, WGMMA_RING_BYTES // stage)
    tiles = (-(-G // WGMMA_BLOCK_M), -(-V // bn))
    return TilePlan("wgmma", WGMMA_BLOCK_M, bn, WGMMA_BLOCK_K, stages, tiles,
                    min(tiles[0] * tiles[1], n_sm), WGMMA_SMEM_FIXED + stages * stage)


@functools.lru_cache(maxsize=256)
def vocab_head_plan(G: int, H: int, V: int, w_dtype: torch.dtype, *, n_sm: int = N_SM) -> TilePlan:
    """The route for h [G, H] against w [H, V] of `w_dtype` (as the
    constants of csrc/vocab_head.cu), from the dtype and the shapes alone.

    bf16 -> route "wgmma" (`_wgmma_plan`), BN the one of WGMMA_BLOCK_NS with
    the shortest critical path: waves (ceil(tiles / n_sm)) times one
    k-stage's time, the longer of its products (proportional to BN) and its
    loads (128 + BN rows of 128 bytes, counted at half the products' rate a
    row), as qmatmul_plan; a tie goes to the wider tile. fp32 -> route
    "tf32x3": 128 x 128 tiles, a 4-stage ring of [128 x 32] h and [32 x 128]
    w fp32 tiles, h rows padded by 4 floats and w rows by 8, reused as the
    [128 x 130] fp32 logits tile. Raises ValueError for another dtype or an
    empty shape."""
    if min(G, H, V, n_sm) < 1:
        raise ValueError(f"vocab_head_plan needs G, H, V and n_sm >= 1, got {(G, H, V, n_sm)}")
    n_row = -(-G // 128)
    if w_dtype == torch.bfloat16:

        def cost(bn: int) -> float:
            waves = -(-(n_row * -(-V // bn)) // n_sm)
            return waves * max(bn, (WGMMA_BLOCK_M + bn) / 2)

        # min keeps the first (widest) of equal costs
        return _wgmma_plan(G, V, min(WGMMA_BLOCK_NS, key=cost), n_sm)
    if w_dtype != torch.float32:
        raise ValueError(f"w must be bf16 or fp32, got {w_dtype}")
    bm, bk, stages = 128, 32, 4
    ring = stages * (bm * (bk + 4) + bk * (TILE_V + 8)) * 4
    tiles = (n_row, -(-V // TILE_V))
    return TilePlan("tf32x3", bm, TILE_V, bk, stages, tiles, tiles[0] * tiles[1],
                    max(ring, bm * (TILE_V + THREADS // bm) * 4))


def _tma_rows(x: torch.Tensor) -> bool:
    """Whether TMA can read x's rows: unit column stride, a row pitch and a
    base that are multiples of TMA_ALIGN bytes."""
    size = x.element_size()
    return (x.stride(1) == 1 and x.stride(0) >= x.shape[1] and x.stride(0) * size % TMA_ALIGN == 0
            and x.data_ptr() % TMA_ALIGN == 0)


def aligned_rows(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [R, C] cast to `dtype` (x's own by default) in rows TMA can read: a
    [R, C] view of a new [R, C'] tensor, C' the least multiple of 16 bytes'
    worth of elements >= C (the columns past C are zero). Values as
    `x.to(dtype)`."""
    dtype = dtype or x.dtype
    R, C = x.shape
    step = TMA_ALIGN // dtype.itemsize
    buf = torch.zeros(R, -(-C // step) * step, device=x.device, dtype=dtype)
    out = buf[:, :C]
    out.copy_(x)
    return out


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


def _w_map(lib, w: torch.Tensor) -> ctypes.Array:
    """The TMA map of bf16 w [H, V] (rows TMA can read), made once per
    (pointer, H, V, pitch) and kept (`WEIGHT_MAPS`)."""
    H, V = w.shape

    def make():
        buf = ctypes.create_string_buffer(lib.vocab_head_map_bytes())
        err = lib.vocab_head_encode_map(buf, w.data_ptr(), H, V, w.stride(0))
        if err:
            raise RuntimeError(f"vocab_head: cuTensorMapEncodeTiled failed ({err}) for w "
                               f"[{H}, {V}] bf16, row pitch {w.stride(0)}")
        return buf

    return cached(WEIGHT_MAPS, (w.data_ptr(), H, V, w.stride(0)), make, CACHE_SIZE)


def vocab_head_topk(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, *, normalize: bool = True,
    return_lse: bool = False,
) -> TopK:
    """Fused ``top_k(h @ w + b)`` (+ log-softmax normalization of the winners).

    h [G, H] any float dtype (cast to w.dtype for the product), w [H, V] bf16
    or fp32, b [V]; returns (vals [G, k] fp32 descending, ids [G, k] int64),
    and with `return_lse` also the row logsumexp lse [G] fp32.
    A CPU tensor takes `vocab_head_topk_plain`; a CUDA tensor launches the
    kernel (one tile launch and one merge launch, counted as one) on the
    route of `vocab_head_plan`. The merge launch writes the lse when it is
    asked for. h and b must be contiguous, and fp32 w too; bf16 w needs
    contiguous rows, read through TMA where their pitch allows
    (`aligned_rows` makes such a w; another is copied into one each call)."""
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
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w must be bf16 or fp32, got {w.dtype}")
    bf16 = w.dtype == torch.bfloat16
    if not (h.is_contiguous() and b.is_contiguous()
            and (w.stride(1) == 1 and w.stride(0) >= V if bf16 else w.is_contiguous())):
        raise ValueError("h and b must be contiguous, w's rows too (fp32 w wholly)")
    dev = h.device
    vals = torch.empty(G, k, device=dev, dtype=torch.float32)
    ids = torch.empty(G, k, device=dev, dtype=torch.int64)
    lse = torch.empty(G, device=dev, dtype=torch.float32) if return_lse else None
    out = (vals, ids, lse) if return_lse else (vals, ids)
    if G == 0:
        return out
    plan = vocab_head_plan(G, H, V, w.dtype, n_sm=sm_count(dev.index))
    hk = h.to(w.dtype)  # as the TPU kernel's h.astype(w.dtype); no copy if h is w.dtype
    lib = LIBRARY.load()
    w_map = None
    if bf16:
        hk = hk if _tma_rows(hk) else aligned_rows(hk)
        w = w if _tma_rows(w) else aligned_rows(w)
        w_map = _w_map(lib, w)
    b32 = b.float()
    n = G * plan.tiles[1]
    part_f = torch.empty(n * (k + 2), device=dev, dtype=torch.float32)  # part_v, part_m, part_s
    part_i = torch.empty(n * k, device=dev, dtype=torch.int64)
    pv = part_f.data_ptr()
    pm, ps = pv + 4 * n * k, pv + 4 * n * (k + 1)
    # the handle of torch.cuda.current_stream(dev), without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (hk.data_ptr(), w.data_ptr(), int(bf16), b32.data_ptr(), pv, part_i.data_ptr(), pm, ps,
            vals.data_ptr(), ids.data_ptr(), G, H, V, k, int(normalize), stream,
            None if lse is None else lse.data_ptr(), plan.block_n if bf16 else 0, plan.blocks,
            w_map, hk.stride(0))
    if dev.index == torch.cuda.current_device():
        err = lib.vocab_head_topk_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.vocab_head_topk_launch(*args)
    LIBRARY.launches += 1
    ROUTE_LAUNCHES[plan.route] += 1
    LIBRARY.check(err)
    return out
