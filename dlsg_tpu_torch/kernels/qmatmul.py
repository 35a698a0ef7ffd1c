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
transposed (K-major, the tensor cores' `.col` B operand) and zero-padded to
Kp = K rounded up to K_ALIGN (`ops/quant.py::quantize_weight` builds it once
per decode). On the card two launches make one call: a row-quantize kernel
writes xq [G, Kp] (zero past K) and sx, then an int8 tensor-core tile kernel
multiplies and rescales. Every step is exact or correctly rounded on both
sides, so the kernel equals `qmatmul_plain` bitwise. Inference only: with a
gradient required it raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dlsg_tpu_torch.kernels._build import ERROR_STRING, CudaLibrary

K_ALIGN = 32  # Kp = K rounded up to this; must match K_ALIGN in csrc/qmatmul.cu
QMAX = 127.0
INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))  # exact in fp32
SCALE_MIN = 1e-12

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "qmatmul",
    {
        "qmatmul_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P], ctypes.c_int),
        "qmatmul_smem_bytes": ([], ctypes.c_int),
        "qmatmul_k_align": ([], ctypes.c_int),
        **ERROR_STRING,
    },
)


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


def qmatmul(x: torch.Tensor, qt: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [G, K] @ dequant(qt, s) -> [G, N] fp32 with x quantized per row
    (module doc). A CPU tensor takes `qmatmul_plain`; a CUDA tensor launches
    the kernel (a quantize launch and a tile launch, counted as one) or
    raises. With a gradient required it raises on either device."""
    if torch.is_grad_enabled() and (x.requires_grad or s.requires_grad):
        raise NotImplementedError("qmatmul is inference only (decode_quant='int8'); it has no backward")
    _check(x, qt, s)
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt, s)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul runs on cuda or cpu tensors, got {x.device}")
    if {x.device, qt.device, s.device} != {x.device}:
        raise ValueError("x, qt and s must be on one device")
    if not (qt.is_contiguous() and s.is_contiguous()) or qt.data_ptr() % 16:
        raise ValueError("qt must be contiguous and 16-byte aligned, s contiguous")
    G, K = x.shape
    N = qt.shape[0]
    dev = x.device
    out = torch.empty(G, N, device=dev, dtype=torch.float32)
    if G == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    x32 = x.float().contiguous()
    xq = torch.empty(G, padded_k(K), device=dev, dtype=torch.int8)
    sx = torch.empty(G, device=dev, dtype=torch.float32)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.qmatmul_launch(
            x32.data_ptr(), qt.data_ptr(), s.data_ptr(), xq.data_ptr(), sx.data_ptr(),
            out.data_ptr(), G, K, N, torch.cuda.current_stream(dev).cuda_stream,
        )
        LIBRARY.launches += 1
    LIBRARY.check(err)
    return out
