"""Int8 product with dynamic per-row activation scales (kernel `csrc/qmatmul.cu`).

Counterpart of `dlsg_tpu/ops/quant.py::qmatmul`, which on the TPU is an XLA
`dot_general` int8 x int8 -> int32 (no Pallas kernel): x [G, K] is cast to
fp32 and quantized per row, sx = max(max|x| * INV_QMAX, 1e-12), xq =
clip(round(x / sx), -127, 127) with round half to even; the int32 product
xq @ q is exact; the output is float(acc) * sx[row] * s[col], multiplied in
that order. INV_QMAX is 1/127 rounded to fp32: under `jit` XLA rewrites the
JAX source's division by the constant 127 into that product (eager JAX
divides; the decode always runs jitted), and the port computes what the
jitted decode computes.

The weight arrives as `qt` int8 [N, Kp]: the quantized kernel q [K, N]
transposed (K-major, as the tensor cores take int8 operands) and
zero-padded to Kp = K rounded up to K_ALIGN (`ops/quant.py::quantize_weight`
builds it once per decode). On the card two launches make one call: a
row-quantize kernel writes xq [G, Kp] (zero past K) and sx into scratch kept
per (device, stream, G, Kp), then a persistent Hopper kernel (TMA loads into
an mbarrier ring, `wgmma` s8 products, a staged 16-byte epilogue) multiplies
and rescales, on the tiles and grid of `qmatmul_plan`. TMA reads each
operand through a tensor map built on the host: the scratch's once with the
scratch, the weight's once per (pointer, N, Kp), cached (`WEIGHT_MAPS`; the
map holds no data, so a weight re-quantized in place, or a new one at a
freed one's address, reuses it rightly). Every step is exact or correctly
rounded on both sides, so the kernel equals `qmatmul_plain` bitwise.
Inference only: with a gradient required it raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary, cached, sm_count
from dlsg_tpu_torch.kernels.lstm_scan import N_SM

K_ALIGN = 32  # Kp = K rounded up to this; must match K_ALIGN in csrc/qmatmul.cu
QMAX = 127.0
INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))  # exact in fp32
SCALE_MIN = 1e-12

# The tile kernel's constants (csrc/qmatmul.cu): 128 output rows a tile (two
# consumer warpgroups of 64), 128 k bytes a ring stage, tile widths of 64 to
# 256 columns in steps of 32, a 192 KB ring, the staged epilogue, its column
# scales and the barriers.
BLOCK_M, BLOCK_K = 128, 128
BLOCK_NS = (256, 224, 192, 160, 128, 96, 64)  # the widths the kernel is built for, widest first
RING_BYTES, MAX_STAGES = 196_608, 8
# align slack, epilogue staging, column scales, barriers
SMEM_FIXED = 1024 + 2 * 64 * (32 + 8) * 4 + 2 * 256 * 4 + 2 * MAX_STAGES * 8
K_MAX = (2**31 - 1) // 127**2  # |int32 sum| <= 127^2 K stays exact up to this K
CACHE_SIZE = 64  # weight maps kept, and scratch buffers (least recently used out)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "qmatmul",
    {
        "qmatmul_launch": ([_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "qmatmul_encode_map": ([_P, _P, _I, _I, _I], ctypes.c_int),
        "qmatmul_map_bytes": ([], ctypes.c_int),
        "qmatmul_smem_bytes": ([_I], ctypes.c_int),
        "qmatmul_k_align": ([], ctypes.c_int),
        **ERROR_STRING,
    },
)


@dataclass(frozen=True)
class QmmPlan:
    """The tile kernel's launch: output tiles of block_m x block_n (row
    tiles x column tiles in `tiles`), a ring of `stages` [block_m + block_n,
    block_k] int8 stages, `smem_bytes` of shared memory and `blocks`
    persistent blocks (at most one per SM)."""

    block_m: int
    block_n: int
    block_k: int
    stages: int
    tiles: Tuple[int, int]
    blocks: int
    smem_bytes: int

    def walk(self, block: int) -> List[Tuple[int, int]]:
        """(row tile, column tile) of each tile `block` computes, in order:
        tile t = block, block + blocks, ...; the row tile is t's fast index,
        so the blocks at work together share a few weight column tiles."""
        n_row, n_col = self.tiles
        return [(t % n_row, t // n_row) for t in range(block, n_row * n_col, self.blocks)]


@functools.lru_cache(maxsize=256)
def qmatmul_plan(G: int, K: int, N: int, n_sm: int = N_SM, block_n: Optional[int] = None) -> QmmPlan:
    """Tiles and grid of the tile kernel for x [G, K] against qt [N, Kp].

    The tile width is the one of BLOCK_NS with the shortest critical path:
    waves (ceil(tiles / n_sm)) times one k-step's time per block, taken as
    the longer of its products (proportional to block_n) and its loads
    (block_m + block_n rows of 128 bytes from L2, counted at half the
    products' rate per row: max(block_n, (block_m + block_n) / 2)); a tie
    goes to the wider tile, whose ring moves fewer bytes per product.
    `block_n` (one of BLOCK_NS) forces the width instead, to time the choice.
    Raises ValueError for an empty shape, K past K_MAX (the int32 sum could
    overflow), no SM or a width the kernel is not built for."""
    if block_n is not None and block_n not in BLOCK_NS:
        raise ValueError(f"block_n must be one of {BLOCK_NS}, got {block_n}")
    if min(G, K, N) < 1 or n_sm < 1:
        raise ValueError(f"qmatmul_plan needs G, K, N and n_sm >= 1, got {(G, K, N, n_sm)}")
    if K > K_MAX:
        raise ValueError(f"K = {K} is past {K_MAX}: 127^2 K could overflow the int32 sum")
    n_row = -(-G // BLOCK_M)

    def cost(bn: int) -> float:
        waves = -(-(n_row * -(-N // bn)) // n_sm)
        return waves * max(bn, (BLOCK_M + bn) / 2)

    bn = block_n or min(BLOCK_NS, key=cost)  # min keeps the first (widest) of equal costs
    stage = (BLOCK_M + bn) * BLOCK_K
    stages = min(MAX_STAGES, RING_BYTES // stage)
    tiles = (n_row, -(-N // bn))
    return QmmPlan(BLOCK_M, bn, BLOCK_K, stages, tiles, min(tiles[0] * tiles[1], n_sm),
                   SMEM_FIXED + stages * stage)


def padded_k(K: int) -> int:
    """K rounded up to K_ALIGN: the row length of `qt` and of the kernel's xq."""
    return -(-K // K_ALIGN) * K_ALIGN


def quantize_rows_plain(x: torch.Tensor):
    """(xq [G, K] fp32 holding integers in [-127, 127], sx [G, 1] fp32): JAX's
    per-row dynamic quantization of x cast to fp32 (module doc)."""
    xf = x.float()
    sx = (xf.abs().amax(dim=-1, keepdim=True) * INV_QMAX).clamp_min(SCALE_MIN)
    return torch.round(xf / sx).clamp(-QMAX, QMAX), sx


def qmatmul_plain(x: torch.Tensor, qt: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [G, K] float, qt int8 [N, padded_k(K)], s
    fp32 [N] -> [G, N] fp32. The integer product runs in float64, exact on
    either device (every partial sum is an integer below 2^53)."""
    K = x.shape[-1]
    xq, sx = quantize_rows_plain(x)
    acc = xq.double() @ qt[:, :K].double().t()
    return acc.float() * sx * s[None, :]


def _check(x: torch.Tensor, qt: torch.Tensor, s: torch.Tensor) -> None:
    if x.dim() != 2 or qt.dim() != 2 or s.dim() != 1:
        raise ValueError("expected x [G, K], qt [N, Kp] and s [N]")
    G, K = x.shape
    N = qt.shape[0]
    if qt.dtype != torch.int8 or s.dtype != torch.float32 or not x.is_floating_point():
        raise ValueError(f"expected float x, int8 qt and fp32 s, got {x.dtype}, {qt.dtype}, {s.dtype}")
    if qt.shape[1] != padded_k(K) or s.shape[0] != N:
        raise ValueError(
            f"qt must be [N, {padded_k(K)}] (K={K} rounded up to {K_ALIGN}) and s [N]: "
            f"x {tuple(x.shape)}, qt {tuple(qt.shape)}, s {tuple(s.shape)}"
        )


# TMA maps of quantized weights by (pointer, N, Kp): bytes the launch copies
WEIGHT_MAPS: "OrderedDict[Tuple[int, int, int], ctypes.Array]" = OrderedDict()
# (device index, stream, G, Kp) -> (xq int8 [G, Kp], sx fp32 [G], xq's TMA map)
_SCRATCH: "OrderedDict[tuple, tuple]" = OrderedDict()
# held over the caches and a call's two launches: the next call on a stream
# reuses its scratch, so no other thread's launches may fall between them
_LOCK = threading.Lock()


def _encode_map(lib, ptr: int, rows: int, Kp: int, weight: bool) -> ctypes.Array:
    """The TMA map of an int8 [rows, Kp] tensor at `ptr`: the scratch xq's,
    or a weight's (its boxes differ; csrc/qmatmul.cu)."""
    buf = ctypes.create_string_buffer(lib.qmatmul_map_bytes())
    err = lib.qmatmul_encode_map(buf, ptr, rows, Kp, weight)
    if err:
        raise RuntimeError(f"qmatmul: cuTensorMapEncodeTiled failed ({err}) for [{rows}, {Kp}] int8")
    return buf


def _scratch(lib, dev: torch.device, stream: int, G: int, Kp: int):
    def make():
        xq = torch.empty(G, Kp, device=dev, dtype=torch.int8)
        sx = torch.empty(G, device=dev, dtype=torch.float32)
        return xq, sx, _encode_map(lib, xq.data_ptr(), G, Kp, weight=False)

    return cached(_SCRATCH, (dev.index, stream, G, Kp), make, CACHE_SIZE)


def qmatmul(x: torch.Tensor, qt: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [G, K] @ dequant(qt, s) -> [G, N] fp32 with x quantized per row
    (module doc). A CPU tensor takes `qmatmul_plain`; a CUDA tensor launches
    the kernel (a quantize launch and a tile launch, counted as one) or
    raises. With a gradient required it raises on either device."""
    if torch.is_grad_enabled() and (x.requires_grad or s.requires_grad):
        raise NotImplementedError("qmatmul is inference only (decode_quant='int8'); it has no backward")
    _check(x, qt, s)
    dev = x.device
    if dev.type == "cpu":
        return qmatmul_plain(x, qt, s)
    if dev.type != "cuda":
        raise ValueError(f"qmatmul runs on cuda or cpu tensors, got {dev}")
    if qt.device != dev or s.device != dev:
        raise ValueError("x, qt and s must be on one device")
    if not (qt.is_contiguous() and s.is_contiguous()) or qt.data_ptr() % 16:
        raise ValueError("qt must be contiguous and 16-byte aligned, s contiguous")
    G, K = x.shape
    N, Kp = qt.shape
    out = torch.empty(G, N, device=dev, dtype=torch.float32)
    if G == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    plan = qmatmul_plan(G, K, N, sm_count(dev.index))
    lib = LIBRARY.load()
    # the handle of torch.cuda.current_stream(dev), without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with _LOCK:
        xq, sx, a_map = _scratch(lib, dev, stream, G, Kp)
        b_map = cached(WEIGHT_MAPS, (qt.data_ptr(), N, Kp),
                       lambda: _encode_map(lib, qt.data_ptr(), N, Kp, weight=True), CACHE_SIZE)
        args = (x.data_ptr(), x.dtype == torch.bfloat16, a_map, b_map, s.data_ptr(),
                xq.data_ptr(), sx.data_ptr(), out.data_ptr(), G, K, N, plan.block_n, plan.blocks,
                stream)
        if dev.index == torch.cuda.current_device():
            err = lib.qmatmul_launch(*args)
        else:
            with torch.cuda.device(dev):
                err = lib.qmatmul_launch(*args)
        LIBRARY.launches += 1
    LIBRARY.check(err)
    return out
