"""Fused vocab head: projection + top-k + logsumexp (kernel `csrc/vocab_head.cu`).

Counterpart of `dlsg_tpu/ops/pallas/vocab_head.py::vocab_head_topk`:
`top_k(h @ w + b)` per row with h cast to w's dtype, fp32 accumulation and an
fp32 bias; values sorted descending, ties to the lowest id (as `lax.top_k`);
with `normalize` the exact row logsumexp is subtracted, and with `return_lse`
it is returned as well (a head split over ranks merges the ranks' top-k and
logsumexp, evaluation/decode.py). On the card the [G, V] logits never reach
device memory.

`vocab_head_plan` picks the kernel's route from w's dtype, both on the
persistent TMA + `wgmma` kernel: bf16 w takes route "wgmma" (one bf16
product, h rounded to bf16 once, here), fp32 w route "wgmma_tf32": three
TF32 products of a hi/lo split of h and w that keep fp32 accuracy. The plan
gives the route's tiles, blocks and shared memory.

`prepare_head` lays w out for its route once per decode
(`Decoder.vocab_head_weights`), a `PreparedHead` that carries its TMA map:
bf16 w in rows TMA reads (`aligned_rows`: rows of ceil8(V)), fp32 w split
into TF32 hi and lo [V, ceil4(H)], K-major as TF32 `wgmma` reads it
(`split_head`; `tf32_split_plain` is the split's plain version, bitwise). On
the CPU it returns the plain [H, V] tensor. A bare w given to the wrapper is
prepared in the call.

TMA reads rows whose pitch is a multiple of 16 bytes from a 16-byte aligned
base. The wrapper lays out h so on every call where it is not (H not a
multiple of 8 for bf16, of 4 for fp32).
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
# The persistent kernel (W_* in csrc/vocab_head.cu): 128 rows a tile (two
# consumer warpgroups of 64), a ring stage of 128-byte rows of k (64 bf16 or
# 32 fp32): 128 rows of h and the tile's w columns, once for bf16 and twice
# (hi, lo) for fp32; tile widths of 128 or 64 columns, a 192 KB ring of at
# most 8 stages, each warpgroup's bias tile, the barriers and 1 KB to align
# the ring.
WGMMA_BLOCK_M, WGMMA_ROW_BYTES = 128, 128
WGMMA_BLOCK_NS = (128, 64)  # the widths the kernel is built for, widest first
WGMMA_RING_BYTES, WGMMA_MAX_STAGES = 196_608, 8
WGMMA_SMEM_FIXED = 1024 + 2 * 128 * 4 + 2 * WGMMA_MAX_STAGES * 8
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "wgmma_tf32"}
TMA_ALIGN = 16  # bytes: a TMA map's base and row pitch are multiples of it
SPLIT_ALIGN = TMA_ALIGN // 4  # the split w's rows: ceil4(H) fp32
TF32_NAN = 0x7FFFE000  # the TF32 rounding's one NaN (csrc/vocab_head.cu)
CACHE_SIZE = 64  # w maps kept (least recently used out)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary(
    "vocab_head",
    {
        "vocab_head_topk_launch": (
            [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _L],
            ctypes.c_int,
        ),
        "vocab_head_split_launch": ([_P, _L, _L, _I, _I, _I, _P, _P], ctypes.c_int),
        "vocab_head_wgmma_smem_bytes": ([_I, _I], ctypes.c_int),
        "vocab_head_map_bytes": ([], ctypes.c_int),
        "vocab_head_encode_map": ([_P, _P, _I, _I, _L], ctypes.c_int),
        "vocab_head_encode_split_map": ([_P, _P, _I, _I], ctypes.c_int),
        **ERROR_STRING,
    },
)
# launches of each route (each also counts in LIBRARY.launches) and of the
# fp32 split (`split_head`, which does not)
ROUTE_LAUNCHES = {"wgmma": 0, "wgmma_tf32": 0, "tf32_split": 0}
# TMA maps of bf16 w by (pointer, H, V, row pitch): bytes the launch copies
WEIGHT_MAPS: "OrderedDict[Tuple[int, int, int, int], ctypes.Array]" = OrderedDict()


@dataclass(frozen=True)
class TilePlan:
    """One route of the kernel: output tiles of block_m x block_n (row tiles
    x vocab tiles in `tiles`), [block_m x block_k] h and [block_k x block_n]
    w tiles (twice for fp32: hi and lo) through `stages` shared-memory
    stages, `blocks` blocks of `smem_bytes` shared memory each: at most one
    a SM, block b walking tiles b, b + blocks, ... with the row tile the fast
    index."""

    route: str
    block_m: int
    block_n: int
    block_k: int
    stages: int
    tiles: Tuple[int, int]
    blocks: int
    smem_bytes: int


def _wgmma_plan(G: int, V: int, bn: int, n_sm: int,
                w_dtype: torch.dtype = torch.bfloat16) -> TilePlan:
    """The persistent kernel's plan for `w_dtype` (bf16 or fp32) at tile
    width `bn` (one of WGMMA_BLOCK_NS): 128 x bn tiles, the deepest ring of
    stages that fits (a stage: [128 x block_k] h, [block_k x bn] w, twice
    for fp32's hi and lo; block_k 128 bytes of k), at most one block per SM.
    The breakdown forces its widths through it."""
    if bn not in WGMMA_BLOCK_NS:
        raise ValueError(f"the tile width must be one of {WGMMA_BLOCK_NS}, got {bn}")
    parts = 2 if w_dtype == torch.float32 else 1
    stage = (WGMMA_BLOCK_M + parts * bn) * WGMMA_ROW_BYTES
    stages = min(WGMMA_MAX_STAGES, WGMMA_RING_BYTES // stage)
    tiles = (-(-G // WGMMA_BLOCK_M), -(-V // bn))
    return TilePlan(ROUTES[w_dtype], WGMMA_BLOCK_M, bn, WGMMA_ROW_BYTES // w_dtype.itemsize, stages,
                    tiles, min(tiles[0] * tiles[1], n_sm), WGMMA_SMEM_FIXED + stages * stage)


@functools.lru_cache(maxsize=256)
def vocab_head_plan(G: int, H: int, V: int, w_dtype: torch.dtype, *, n_sm: int = N_SM) -> TilePlan:
    """The route for h [G, H] against w [H, V] of `w_dtype` (as the
    constants of csrc/vocab_head.cu), from the dtype and the shapes alone:
    bf16 -> "wgmma", fp32 -> "wgmma_tf32" (`_wgmma_plan`). BN is the one of
    WGMMA_BLOCK_NS with the shortest critical path: waves (ceil(tiles /
    n_sm)) times one k-stage's time, the longer of its products
    (proportional to BN) and its loads (128 + BN rows of 128 bytes, counted
    at half the products' rate a row), as qmatmul_plan, for either dtype; a
    tie goes to the wider tile. Raises ValueError for another dtype or an
    empty shape."""
    if min(G, H, V, n_sm) < 1:
        raise ValueError(f"vocab_head_plan needs G, H, V and n_sm >= 1, got {(G, H, V, n_sm)}")
    if w_dtype not in ROUTES:
        raise ValueError(f"w must be bf16 or fp32, got {w_dtype}")
    n_row = -(-G // WGMMA_BLOCK_M)

    def cost(bn: int) -> float:
        waves = -(-(n_row * -(-V // bn)) // n_sm)
        return waves * max(bn, (WGMMA_BLOCK_M + bn) / 2)

    # min keeps the first (widest) of equal costs
    return _wgmma_plan(G, V, min(WGMMA_BLOCK_NS, key=cost), n_sm, w_dtype)


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


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 fraction bits) half away from zero, the 13
    low bits zero, as csrc/vocab_head.cu's tf32_rna: an integer add and
    mask on the bit pattern, a NaN giving 0x7fffe000."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = torch.where(torch.isnan(x), TF32_NAN, (u + 0x1000) & 0xFFFFE000)
    return (r - ((r >> 31) << 32)).to(torch.int32).view(torch.float32)


def tf32_split_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the split kernel: fp32 w [H, V] -> parts [2, V, Hp]
    fp32, Hp = ceil4(H): hi = tf32(w) and lo = tf32(w - hi) of w's column n
    in row n of each part (K-major), zeros past H; lo is 0 where hi is inf
    or NaN. Bitwise the kernel's."""
    H, V = w.shape
    x = torch.zeros(V, -(-H // SPLIT_ALIGN) * SPLIT_ALIGN, device=w.device, dtype=torch.float32)
    x[:, :H] = w.t()
    hi = _tf32_rna(x)
    lo = torch.where(torch.isfinite(hi), _tf32_rna(x - hi), 0.0)
    return torch.stack([hi, lo])


@dataclass(frozen=True, eq=False)
class PreparedHead:
    """w [H, V] laid out for its route (`prepare_head`, `split_head`): `w`
    the head the plain version reads (bf16 in rows TMA reads, which the
    kernel reads too; fp32 the source), `parts` fp32's TF32 hi and lo [2, V,
    Hp] (`tf32_split_plain`'s layout; None for bf16) and `map` the TMA map of
    what the kernel reads (None on the CPU). Made from the weights of that
    moment, never cached."""

    w: torch.Tensor
    parts: Optional[torch.Tensor]
    map: Optional[ctypes.Array]

    @property
    def shape(self) -> torch.Size:
        return self.w.shape

    @property
    def device(self) -> torch.device:
        return self.w.device

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    def empty_like(self) -> "PreparedHead":
        """A head of this one's shape and layout in storage of its own, with
        its own TMA map (its values unset): what a CUDA graph reads in place
        of each decode's head, which `copy_` writes there."""
        if self.parts is None and self.map is not None:
            w = aligned_rows(self.w)  # bf16 rows TMA reads, as prepare_head lays them out
            return PreparedHead(w, None, _w_map(LIBRARY.load(), w))
        w = torch.empty_strided(self.w.shape, self.w.stride(), dtype=self.w.dtype, device=self.device)
        if self.parts is None:
            return PreparedHead(w, None, None)
        parts = torch.empty_like(self.parts)
        return PreparedHead(w, parts, None if self.map is None else _split_map(LIBRARY.load(), parts))

    def copy_(self, src: "PreparedHead") -> None:
        """This head's storage refilled from `src`, a head of its layout."""
        self.w.copy_(src.w)
        if self.parts is not None:
            self.parts.copy_(src.parts)


def split_head(w: torch.Tensor) -> PreparedHead:
    """fp32 w [H, V] (any strides) split into TF32 hi and lo, K-major: on a
    CUDA tensor one launch of the split kernel (counted in
    ROUTE_LAUNCHES["tf32_split"]) and the parts' TMA map; on the CPU
    `tf32_split_plain`."""
    if w.dim() != 2 or w.dtype != torch.float32 or min(w.shape) < 1:
        raise ValueError(f"split_head takes a non-empty fp32 w [H, V], got {w.dtype} {tuple(w.shape)}")
    if w.device.type == "cpu":
        return PreparedHead(w, tf32_split_plain(w), None)
    if w.device.type != "cuda":
        raise ValueError(f"split_head runs on cuda or cpu tensors, got {w.device}")
    H, V = w.shape
    Hp = -(-H // SPLIT_ALIGN) * SPLIT_ALIGN
    dev = w.device
    parts = torch.empty(2, V, Hp, device=dev, dtype=torch.float32)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.vocab_head_split_launch(w.data_ptr(), w.stride(0), w.stride(1), H, V, Hp,
                                          parts.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    ROUTE_LAUNCHES["tf32_split"] += 1
    LIBRARY.check(err)
    return PreparedHead(w, parts, _split_map(lib, parts))


def _split_map(lib, parts: torch.Tensor) -> ctypes.Array:
    """The TMA map of a split w's parts [2, V, Hp]."""
    _, V, Hp = parts.shape
    buf = ctypes.create_string_buffer(lib.vocab_head_map_bytes())
    err = lib.vocab_head_encode_split_map(buf, parts.data_ptr(), V, Hp)
    if err:
        raise RuntimeError(f"vocab_head: cuTensorMapEncodeTiled failed ({err}) for the split w "
                           f"[2, {V}, {Hp}]")
    return buf


def prepare_head(w: torch.Tensor, dtype: torch.dtype) -> Union[torch.Tensor, PreparedHead]:
    """w [H, V] (any strides) in `dtype` as `vocab_head_topk` reads it, laid
    out once per decode. On the CPU the plain tensor w.to(dtype): bf16 in
    rows TMA reads (`aligned_rows`), fp32 contiguous. On the card a
    `PreparedHead` with its TMA map: bf16 in such rows, fp32 split into TF32
    hi and lo (`split_head`)."""
    if dtype not in ROUTES:
        raise ValueError(f"w must be bf16 or fp32, got {dtype}")
    cpu = w.device.type == "cpu"
    if dtype == torch.float32:
        return w.float().contiguous() if cpu else split_head(w.float())
    rows = w if w.dtype == dtype and _tma_rows(w) else aligned_rows(w, dtype)
    return rows if cpu else PreparedHead(rows, None, _w_map(LIBRARY.load(), rows))


TopK = Union[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


Weight = Union[torch.Tensor, PreparedHead]


def vocab_head_topk_plain(
    h: torch.Tensor, w: Weight, b: torch.Tensor, k: int, *, normalize: bool = True,
    return_lse: bool = False,
) -> TopK:
    """Plain PyTorch version: fp32 logits from the w.dtype-rounded operands
    (a PreparedHead's w), a stable descending sort, then `torch.logsumexp`."""
    if isinstance(w, PreparedHead):
        w = w.w
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
    h: torch.Tensor, w: Weight, b: torch.Tensor, k: int, *, normalize: bool = True,
    return_lse: bool = False,
) -> TopK:
    """Fused ``top_k(h @ w + b)`` (+ log-softmax normalization of the winners).

    h [G, H] any float dtype (cast to w's dtype for the product), w [H, V]
    bf16 or fp32 or its `PreparedHead`, b [V]; returns (vals [G, k] fp32
    descending, ids [G, k] int64), and with `return_lse` also the row
    logsumexp lse [G] fp32.
    A CPU tensor takes `vocab_head_topk_plain`; a CUDA tensor launches the
    kernel (one tile launch and one merge launch, counted as one) on the
    route of `vocab_head_plan`. The merge launch writes the lse when it is
    asked for. h and b must be contiguous, a bare bf16 w's rows too; a bare
    w is prepared in the call (`prepare_head`: a bf16 w's TMA map is kept
    by pointer, an fp32 w is split)."""
    if h.device.type == "cpu":
        return vocab_head_topk_plain(h, w, b, k, normalize=normalize, return_lse=return_lse)
    if h.device.type != "cuda":
        raise ValueError(f"vocab_head_topk runs on cuda or cpu tensors, got {h.device}")
    prepared = isinstance(w, PreparedHead)
    if h.dim() != 2 or b.dim() != 1 or (not prepared and w.dim() != 2):
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
    if w.dtype not in ROUTES:
        raise ValueError(f"w must be bf16 or fp32, got {w.dtype}")
    bf16 = w.dtype == torch.bfloat16
    if not (h.is_contiguous() and b.is_contiguous()
            and (prepared or not bf16 or (w.stride(1) == 1 and w.stride(0) >= V))):
        raise ValueError("h and b must be contiguous, bf16 w's rows too")
    dev = h.device
    vals = torch.empty(G, k, device=dev, dtype=torch.float32)
    ids = torch.empty(G, k, device=dev, dtype=torch.int64)
    lse = torch.empty(G, device=dev, dtype=torch.float32) if return_lse else None
    out = (vals, ids, lse) if return_lse else (vals, ids)
    if G == 0:
        return out
    plan = vocab_head_plan(G, H, V, w.dtype, n_sm=sm_count(dev.index))
    hk = h.to(w.dtype)  # as the TPU kernel's h.astype(w.dtype); no copy if h is w's dtype
    hk = hk if _tma_rows(hk) else aligned_rows(hk)
    # held to the launch: a bare fp32 w's split is freed after it
    head = w if prepared else prepare_head(w, w.dtype)
    lib = LIBRARY.load()
    b32 = b.float()
    n = G * plan.tiles[1]
    part_f = torch.empty(n * (k + 2), device=dev, dtype=torch.float32)  # part_v, part_m, part_s
    part_i = torch.empty(n * k, device=dev, dtype=torch.int64)
    pv = part_f.data_ptr()
    pm, ps = pv + 4 * n * k, pv + 4 * n * (k + 1)
    # the handle of torch.cuda.current_stream(dev), without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (hk.data_ptr(), int(not bf16), b32.data_ptr(), pv, part_i.data_ptr(), pm, ps,
            vals.data_ptr(), ids.data_ptr(), G, H, V, k, int(normalize), stream,
            None if lse is None else lse.data_ptr(), plan.block_n, plan.blocks, head.map, hk.stride(0))
    if dev.index == torch.cuda.current_device():
        err = lib.vocab_head_topk_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.vocab_head_topk_launch(*args)
    LIBRARY.launches += 1
    ROUTE_LAUNCHES[plan.route] += 1
    LIBRARY.check(err)
    return out
