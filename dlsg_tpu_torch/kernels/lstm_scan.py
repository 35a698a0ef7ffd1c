"""LSTM sequence scan over pre-projected inputs (kernel `csrc/lstm_scan.cu`).

Counterpart of `dlsg_tpu/ops/pallas/lstm_scan.py::lstm_scan_pallas`: one LSTM
direction with h0 = c0 = 0, h kept in fp32, W_hh rounded to bf16, fp32
accumulation, gates in (i, f, g, o) order. Forward only: with a gradient
required it raises, as JAX cannot differentiate the Pallas kernel either.

On the card one cooperative launch runs the whole direction: each block keeps
its slice of W_hh in shared memory for all steps and takes h_{t-1} through
TMA from a ping-pong scratch, and a barrier on a global counter separates
the steps, so every block must be resident at once. `lstm_scan_plan` says
how a shape is cut into blocks and whether it fits.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary, sm_count

N_SM = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt in to on Hopper (227 KB)
# The kernel's constants (csrc/lstm_scan.cu): 64 batch rows a tile (one
# consumer warpgroup), h_{t-1} in [64 x 32] fp32 chunks (8 KB) through a ring
# of 2 to 8 stages of 2 chunks (of 1 where shared memory is short), W_hh's
# slice padded to 64 k, 1 KB to align the ring and W_hh for the 128-byte
# swizzle, the ring's barriers.
ROWS, CHUNK_K = 64, 32
CHUNK_BYTES = ROWS * CHUNK_K * 4
MIN_STAGES, MAX_STAGES = 2, 8
UNITS = (8, 16)  # hidden units a block, in the order tried (a tie keeps the first)
SMEM_FIXED = 1024 + 2 * MAX_STAGES * 8
# per-SM rates of an H100 SXM for the plan's cost: h bytes from L2 (qmatmul's
# ring fills, ~8.4 TB/s over 132 SMs) and bf16 tensor-core operations
L2_BYTES_PER_S, BF16_OPS_PER_S = 8.4e12 / 132, 989e12 / 132

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "lstm_scan",
    {
        "lstm_scan_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "lstm_scan_smem_bytes": ([_I, _I, _I, _I, _I, _I], ctypes.c_longlong),
        **ERROR_STRING,
    },
)


@dataclass(frozen=True)
class ScanPlan:
    """How one direction is launched: `groups` x ceil(H / units) blocks of
    160 threads (a consumer warpgroup and a producer warp), block (group,
    unit block) owning `units` hidden units (all four gate columns) for the
    64-row batch tiles group, group + groups, ...; h_{t-1} through a ring of
    `stages` stages of `boxes` [64 x 32] fp32 chunks; `smem_bytes` of
    dynamic shared memory."""

    units: int
    groups: int
    blocks: int
    stages: int
    boxes: int
    smem_bytes: int


def _smem_bytes(B: int, H: int, units: int, groups: int, stages: int, boxes: int) -> int:
    """Ring + W_hh slice [ceil64(H), 4 units] bf16 + c [64, units] fp32 for
    each of a block's row tiles + align slack and barriers (as `smem_bytes`
    in the source)."""
    tiles = -(-(-(-B // ROWS)) // groups)
    return (SMEM_FIXED + stages * boxes * CHUNK_BYTES + -(-H // 64) * 64 * 4 * units * 2
            + tiles * ROWS * units * 4)


def _ring(B: int, H: int, units: int, groups: int,
          boxes: Optional[int] = None) -> Optional[ScanPlan]:
    """The plan at (units, groups) with the deepest ring that fits (at most
    MAX_STAGES): stages of `boxes` chunks, or by default of two chunks if at
    least MIN_STAGES of them fit, else of one; None if not even MIN_STAGES
    stages do. The breakdown forces its alternatives through it."""
    fixed = _smem_bytes(B, H, units, groups, 0, 1)
    for n in (2, 1) if boxes is None else (boxes,):
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (n * CHUNK_BYTES))
        if stages >= MIN_STAGES:
            return ScanPlan(units, groups, groups * -(-H // units), stages, n,
                            fixed + stages * n * CHUNK_BYTES)
    return None


def _candidates(B: int, H: int, n_sm: int):
    """(cost, plan) of every (units, groups) that fits: all blocks on the
    SMs at once, shared memory with a ring of at least MIN_STAGES chunks
    (`_ring`). The cost is a step's time on one block: its row tiles, each
    the longer of moving 64 rows of h_{t-1} from L2 and its three bf16
    products."""
    n_rt = -(-B // ROWS)
    for units in UNITS:
        nb = -(-H // units)
        groups = min(n_sm // nb, n_rt) if nb <= n_sm else 0
        plan = _ring(B, H, units, groups) if groups >= 1 else None
        if plan is None:
            continue
        hp = -(-H // CHUNK_K) * CHUNK_K
        per_tile = max(ROWS * hp * 4 / L2_BYTES_PER_S, 3 * 2 * ROWS * hp * 4 * units / BF16_OPS_PER_S)
        yield -(-n_rt // groups) * per_tile, plan


@functools.lru_cache(maxsize=256)
def max_hidden(B: int, *, n_sm: int = N_SM) -> int:
    """The largest hidden size `lstm_scan_plan` accepts for batch B (0 if
    none): a plan fits at H if it fits at any smaller H."""
    lo, hi = 0, max(UNITS) * n_sm
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if next(_candidates(B, mid, n_sm), None) is not None:
            lo = mid
        else:
            hi = mid - 1
    return lo


@functools.lru_cache(maxsize=256)
def lstm_scan_plan(B: int, H: int, *, n_sm: int = N_SM) -> ScanPlan:
    """The launch of one direction at batch B and hidden size H: the
    cheapest (units, groups) of `_candidates` (at B = 128, H = 1024: 16
    units x 64 blocks x 2 groups of one 64-row tile each, 5 stages of two
    chunks in the ring). Raises ValueError when nothing fits the `n_sm`
    co-resident blocks of SMEM_LIMIT bytes."""
    options = list(_candidates(B, H, n_sm))
    if not options:
        raise ValueError(
            f"lstm_scan: H={H} at B={B} does not fit: W_hh must stay in the shared memory of at "
            f"most {n_sm} co-resident blocks of {SMEM_LIMIT} bytes; the largest H for this batch "
            f"is {max_hidden(B, n_sm=n_sm)}"
        )
    return min(options, key=lambda cp: cp[0])[1]  # min keeps the first of equal costs


def lstm_scan_plain(xw: torch.Tensor, w_hh: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the per-step loop with W_hh rounded to bf16.

    xw [B, T, 4H] fp32 (x @ W_ih + b), w_hh [H, 4H] -> hs [B, T, H] fp32."""
    B, T, G = xw.shape
    H = G // 4
    u = w_hh.to(torch.bfloat16).float()
    h = xw.new_zeros(B, H)
    c = xw.new_zeros(B, H)
    hs = xw.new_empty(B, T, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[:, t] + h @ u
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[:, t] = h
    return hs


def lstm_scan(xw: torch.Tensor, w_hh: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """Run one LSTM direction over `xw` [B, T, 4H] (fp32) with recurrent
    weights `w_hh` [H, 4H]; returns hs [B, T, H] fp32. `reverse` scans right
    to left with outputs at their input positions.

    A CPU tensor takes `lstm_scan_plain`; a CUDA tensor launches the kernel
    (one launch per call) or raises, ValueError for a shape whose W_hh does
    not fit (`lstm_scan_plan`). The kernel has no backward (nor has the JAX
    one), so on either device a call that autograd would have to
    differentiate raises NotImplementedError."""
    if torch.is_grad_enabled() and (xw.requires_grad or w_hh.requires_grad):
        raise NotImplementedError(
            "lstm_scan has no backward kernel; set use_pallas_lstm=False to train"
        )
    if xw.device.type == "cpu":
        return lstm_scan_plain(xw, w_hh, reverse=reverse)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_scan runs on cuda or cpu tensors, got {xw.device}")
    if xw.dim() != 3 or xw.dtype != torch.float32 or not xw.is_contiguous():
        raise ValueError(
            f"xw must be a contiguous fp32 [B, T, 4H] tensor, got {xw.dtype} {tuple(xw.shape)}"
        )
    B, T, G = xw.shape
    H = G // 4
    if G != 4 * H or tuple(w_hh.shape) != (H, G):
        raise ValueError(f"w_hh must be [{H}, {G}] for xw {tuple(xw.shape)}, got {tuple(w_hh.shape)}")
    if w_hh.device != xw.device or not w_hh.is_floating_point():
        raise ValueError("w_hh must be a float tensor on xw's device")
    hs = torch.empty(B, T, H, device=xw.device, dtype=torch.float32)
    if B == 0 or T == 0 or H == 0:
        return hs
    plan = lstm_scan_plan(B, H, n_sm=sm_count(xw.device.index))
    u = w_hh.to(torch.bfloat16).contiguous()
    u = u if u.data_ptr() % 16 == 0 else u.clone()  # the prologue's 16-byte loads
    # h_t for the next step's TMA loads [2, B, ceil4(H)] (16-byte row pitch),
    # then the barrier's counter (the launch zeroes it)
    n = 2 * B * -(-H // 4) * 4
    scratch = torch.empty(n + 4, device=xw.device, dtype=torch.float32)
    dev = xw.device.index
    # the handle of torch.cuda.current_stream(dev), without building a Stream
    args = (xw.data_ptr(), u.data_ptr(), hs.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * n, B, T, H, plan.units, plan.groups, plan.stages, plan.boxes,
            int(reverse), torch._C._cuda_getCurrentRawStream(dev))
    lib = LIBRARY.load()
    if dev == torch.cuda.current_device():
        err = lib.lstm_scan_launch(*args)
    else:
        with torch.cuda.device(xw.device):
            err = lib.lstm_scan_launch(*args)
    LIBRARY.launches += 1
    LIBRARY.check(err)
    return hs
