"""LSTM sequence scan over pre-projected inputs (kernel `csrc/lstm_scan.cu`).

Counterpart of `dlsg_tpu/ops/pallas/lstm_scan.py::lstm_scan_pallas`: one LSTM
direction with h0 = c0 = 0, h kept in fp32, W_hh rounded to bf16, fp32
accumulation, gates in (i, f, g, o) order. Forward only: with a gradient
required it raises, as JAX cannot differentiate the Pallas kernel either.

On the card one cooperative launch runs the whole direction: each block keeps
its slice of W_hh in shared memory for all steps, and a grid barrier
separates the steps, so every block must be resident at once.
`lstm_scan_plan` says how a shape is cut into blocks and whether it fits.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary

N_SM = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt in to on Hopper (227 KB)
ROWS = 128  # batch rows per row tile; a larger batch loops over row tiles
# (units per block, chunk_k, stages of the h-chunk ring), in the order tried
SHAPES = ((8, 64, 4), (8, 64, 2), (16, 16, 2))

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "lstm_scan",
    {
        "lstm_scan_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "lstm_scan_smem_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
        **ERROR_STRING,
    },
)


@dataclass(frozen=True)
class ScanPlan:
    """How one direction is launched: `blocks` blocks of 256 threads, each
    owning `units` hidden units (all four gate columns), with `smem_bytes` of
    dynamic shared memory."""

    units: int
    blocks: int
    chunk_k: int  # k-width of the h_{t-1} chunks streamed per step
    stages: int  # chunks in the shared-memory ring
    smem_bytes: int


def _smem_bytes(B: int, H: int, units: int, chunk_k: int, stages: int) -> int:
    """W_hh slice [ceil16(H), 4 units] bf16 + a ring of `stages` [ROWS,
    chunk_k + 8] fp32 h chunks + c [ceil(B / ROWS) ROWS, units] fp32 (as
    `smem_bytes` in the source)."""
    hp = -(-H // 16) * 16
    return (hp * 4 * units * 2 + stages * ROWS * (chunk_k + 8) * 4
            + -(-B // ROWS) * ROWS * units * 4)


def max_hidden(B: int, *, n_sm: int = N_SM) -> int:
    """The largest hidden size `lstm_scan_plan` accepts for batch B."""
    best = 0
    for units, chunk_k, stages in SHAPES:
        rest = SMEM_LIMIT - _smem_bytes(B, 0, units, chunk_k, stages)
        hp = max(rest, 0) // (4 * units * 2) // 16 * 16
        best = max(best, min(units * n_sm, hp))
    return best


def lstm_scan_plan(B: int, H: int, *, n_sm: int = N_SM) -> ScanPlan:
    """The launch of one direction at batch B and hidden size H: the first
    of SHAPES whose blocks fit on the SMs and in shared memory (8 units a
    block with a 4-chunk ring at the repo's widths). Raises ValueError when
    the W_hh slices do not fit the shared memory of `n_sm` blocks."""
    for units, chunk_k, stages in SHAPES:
        plan = ScanPlan(units, -(-H // units), chunk_k, stages,
                        _smem_bytes(B, H, units, chunk_k, stages))
        if plan.blocks <= n_sm and plan.smem_bytes <= SMEM_LIMIT:
            return plan
    raise ValueError(
        f"lstm_scan: H={H} at B={B} does not fit: W_hh must stay in the shared memory of at "
        f"most {n_sm} co-resident blocks of {SMEM_LIMIT} bytes; the largest H for this batch "
        f"is {max_hidden(B, n_sm=n_sm)}"
    )


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
    n_sm = torch.cuda.get_device_properties(xw.device).multi_processor_count
    plan = lstm_scan_plan(B, H, n_sm=n_sm)
    u = w_hh.to(torch.bfloat16).contiguous()
    lib = LIBRARY.load()
    with torch.cuda.device(xw.device):
        err = lib.lstm_scan_launch(
            xw.data_ptr(), u.data_ptr(), hs.data_ptr(), B, T, H, plan.units, plan.stages,
            int(reverse), torch.cuda.current_stream(xw.device).cuda_stream,
        )
        LIBRARY.launches += 1
    LIBRARY.check(err)
    return hs
