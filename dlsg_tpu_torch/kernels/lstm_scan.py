"""LSTM sequence scan over pre-projected inputs (kernel `csrc/lstm_scan.cu`).

Counterpart of `dlsg_tpu/ops/pallas/lstm_scan.py::lstm_scan_pallas`: one LSTM
direction with h0 = c0 = 0, h kept in fp32, W_hh rounded to bf16, fp32
accumulation, gates in (i, f, g, o) order. Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "lstm_scan",
    {
        "lstm_scan_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
        **ERROR_STRING,
    },
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
    (T step launches, counted as one in `LIBRARY.launches`)."""
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
    u = w_hh.to(torch.bfloat16).contiguous()
    c = torch.empty(B, H, device=xw.device, dtype=torch.float32)
    lib = LIBRARY.load()
    with torch.cuda.device(xw.device):
        err = lib.lstm_scan_launch(
            xw.data_ptr(), u.data_ptr(), hs.data_ptr(), c.data_ptr(),
            B, T, H, int(reverse), torch.cuda.current_stream(xw.device).cuda_stream,
        )
        LIBRARY.launches += 1
    LIBRARY.check(err)
    return hs
