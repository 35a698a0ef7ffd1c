"""LSTM primitives (counterpart of `dlsg_tpu/ops/lstm.py`).

Plain tensor code, not `nn.LSTM`: cuDNN's LSTM refuses the double backward
that WGAN-GP training needs, and its weight layout is not the JAX one. The
layout here is the JAX one: `ih` is a Dense whose bias already sums b_ih and
b_hh, `w_hh` is [H, 4H], gates are in (i, f, g, o) order. Matmuls run in the
config's compute dtype with fp32 accumulation; gate math and cell state are
fp32 unless `lstm_gates` is given bf16.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from dlsg_tpu_torch.kernels.lstm_scan import lstm_scan
from dlsg_tpu_torch.ops.linear import Dense, matmul_f32


def lstm_gates(
    gates: torch.Tensor, c: torch.Tensor, dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', c') from gate pre-activations [B, 4H] and the previous cell state.

    With `dtype=bfloat16` the sigmoids/tanh run on bf16 gate values while the
    cell state and its update stay fp32 (the JAX decoder's bf16 gate chain)."""
    if dtype == torch.bfloat16:
        i, f, g, o = gates.to(dtype).chunk(4, dim=-1)
        c_new = torch.sigmoid(f).float() * c + (torch.sigmoid(i) * torch.tanh(g)).float()
        h_new = torch.sigmoid(o).float() * torch.tanh(c_new)
        return h_new, c_new
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(
    xw: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    w_hh: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step given the pre-projected input xw [B, 4H]; the recurrent
    matmul runs in `dtype` with fp32 accumulation. Returns fp32 (h', c')."""
    gates = xw.float() + matmul_f32(h.to(dtype), w_hh.to(dtype))
    return lstm_gates(gates, c)


def _w_hh_param(features: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(features, 4 * features))


class LSTMCell(nn.Module):
    """Fused-gate LSTM cell (the decoder's language cell)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ih = Dense(in_features, 4 * features, dtype=dtype)
        self.w_hh = _w_hh_param(features)

    def reset_parameters(self, generator=None) -> None:
        nn.init.orthogonal_(self.w_hh.data, generator=generator)

    def forward(self, x, h, c):
        return lstm_step(self.ih(x), h, c, self.w_hh, self.dtype)

    def fused_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W [in+H, 4H] in compute dtype, b [4H] fp32) for `[x, h] @ W + b`."""
        w = torch.cat([self.ih.kernel(), self.w_hh], dim=0).to(self.dtype).contiguous()
        return w, self.ih.bias.float()


class SplitInputLSTMCell(nn.Module):
    """LSTMCell whose input projection is split into a per-step part
    (`ih_dyn`, with the bias) and a loop-invariant part (`ih_static`, no
    bias) computed once per sequence. Used by the decoder's query LSTM."""

    def __init__(
        self, dyn_features: int, static_features: int, features: int,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.ih_dyn = Dense(dyn_features, 4 * features, dtype=dtype)
        self.ih_static = Dense(static_features, 4 * features, bias=False, dtype=dtype)
        self.w_hh = _w_hh_param(features)

    def reset_parameters(self, generator=None) -> None:
        nn.init.orthogonal_(self.w_hh.data, generator=generator)

    def project_static(self, x_static):
        """The loop-invariant slice of the input projection, [B, 4H]."""
        return self.ih_static(x_static)

    def forward(self, x_dyn, xw_static, h, c):
        xw = self.ih_dyn(x_dyn).float() + xw_static.float()
        return lstm_step(xw, h, c, self.w_hh, self.dtype)

    def fused_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W [dyn_in+H, 4H] in compute dtype, b [4H] fp32) for
        `[x_dyn, h] @ W + b + xw_static` as one per-step matmul."""
        w = torch.cat([self.ih_dyn.kernel(), self.w_hh], dim=0).to(self.dtype).contiguous()
        return w, self.ih_dyn.bias.float()


class LSTMSequence(nn.Module):
    """Unidirectional LSTM over [B, T, X]. The input projection is one matmul
    over the whole sequence; with `use_pallas` the recurrence runs as the
    `lstm_scan` kernel (the JAX package's Pallas switch, same name)."""

    def __init__(
        self, in_features: int, features: int, reverse: bool = False,
        dtype: torch.dtype = torch.float32, use_pallas: bool = False,
    ):
        super().__init__()
        self.features = features
        self.reverse = reverse
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.ih = Dense(in_features, 4 * features, dtype=dtype)
        self.w_hh = _w_hh_param(features)

    def reset_parameters(self, generator=None) -> None:
        nn.init.orthogonal_(self.w_hh.data, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xw = self.ih(x)  # [B, T, 4H] in compute dtype
        if self.use_pallas:
            return lstm_scan(xw.float().contiguous(), self.w_hh, reverse=self.reverse)
        B, T, _ = x.shape
        h = x.new_zeros(B, self.features, dtype=torch.float32)
        c = torch.zeros_like(h)
        hs = [None] * T
        for t in (range(T - 1, -1, -1) if self.reverse else range(T)):
            h, c = lstm_step(xw[:, t], h, c, self.w_hh, self.dtype)
            hs[t] = h
        return torch.stack(hs, dim=1)  # [B, T, H]


class BiLSTM(nn.Module):
    """Forward and backward scans concatenated: [B, T, 2H]."""

    def __init__(
        self, in_features: int, features: int, dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.fwd = LSTMSequence(in_features, features, False, dtype, use_pallas)
        self.bwd = LSTMSequence(in_features, features, True, dtype, use_pallas)

    def forward(self, x):
        return torch.cat([self.fwd(x), self.bwd(x)], dim=-1)
