"""Int8 quantized inference matmuls (counterpart of `dlsg_tpu/ops/quant.py`).

Weights: symmetric per-output-column int8 with fp32 scales, quantized once
per decode in `DecoderStep.precompute`. Activations: symmetric per-row
dynamic int8. The int32 product is rescaled to fp32 by s_row * s_col
(`qmatmul`, kernel `csrc/qmatmul.cu` on the card). Inference only
(`cfg.decode_quant='int8'`); training never quantizes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dlsg_tpu_torch.kernels.qmatmul import (  # noqa: F401  (this module's API)
    INV_QMAX,
    QMAX,
    SCALE_MIN,
    padded_k,
    qmatmul,
    qmatmul_plain,
)


class QuantWeight(NamedTuple):
    """A kernel [K, N] as `qmatmul` takes it: qt int8 [N, padded_k(K)], the
    quantized kernel transposed (K-major) and zero past K; s fp32 [N]."""

    qt: torch.Tensor
    s: torch.Tensor


def quantize_per_col(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float -> (int8 [in, out], fp32 scale [out]); symmetric, as
    JAX's under jit: the max |w| of each column times INV_QMAX, 1/127 in fp32
    (XLA's form of the source's division by 127; kernels/qmatmul.py), at
    least 1e-12, then w / s rounded half to even and clipped to [-127, 127]."""
    w = w.float()
    s = (w.abs().amax(dim=0) * INV_QMAX).clamp_min(SCALE_MIN)
    q = torch.round(w / s[None, :]).clamp(-QMAX, QMAX).to(torch.int8)
    return q, s


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """`quantize_per_col(w)` in the layout `qmatmul` takes (QuantWeight)."""
    q, s = quantize_per_col(w)
    K, N = q.shape
    qt = torch.zeros(N, padded_k(K), dtype=torch.int8, device=q.device)
    qt[:, :K] = q.t()
    return QuantWeight(qt, s)
