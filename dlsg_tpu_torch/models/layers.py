"""Shared sublayers (counterpart of `dlsg_tpu/models/layers.py`).

Feature axis last everywhere, as in the JAX package. Masks are float tensors
where >0 means keep; masked logits are filled with -9e15 like the reference.

Dropout sits where the JAX modules put it, with their rates, which are
hard-coded there (the config's `dropout` does not set them): 0.2 in
`PositionalEncoding`, the `dropout` argument of `SelfAttention`, 0.1 in
`AttentionShare`, 0.3 in `LatentPSL`. A forward drops out only in training
mode and when given a generator `rng` (ops/linear.py::dropout).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from dlsg_tpu_torch.ops.linear import (  # noqa: F401
    LN_EPS,
    Dense,
    Dropout,
    LayerNorm,
    matmul_f32,
    trunc_normal_fan_,
)
from dlsg_tpu_torch.ops.remat import not_a_dot

NEG_FILL = -9e15  # reference mask fill value

# torch `xavier_uniform_(w, gain=calculate_gain('tanh'))`
TANH_GAIN = 5.0 / 3.0


def xavier_uniform_gain_(w: torch.Tensor, gain: float, generator=None) -> torch.Tensor:
    """Uniform(-l, l), l = gain * sqrt(6 / (fan_in + fan_out)), with the JAX
    package's fans for a [fan_in, fan_out] parameter."""
    limit = gain * math.sqrt(6.0 / (w.shape[-2] + w.shape[-1]))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


class PositionalEncoding(nn.Module):
    """Sin/cos positional encoding added to x, then dropout (reference
    sublayer.py:85-104)."""

    def __init__(self, d_model: int, max_len: int = 72, dropout: float = 0.2):
        super().__init__()
        self.drop = Dropout(dropout)
        pe = np.zeros((max_len, d_model), dtype=np.float32)
        position = np.arange(0.0, max_len)[:, None]
        div_term = np.exp(np.arange(0.0, d_model, 2) * -(math.log(10000.0) / d_model))
        pe[:, 0::2] = np.sin(position * div_term)
        pe[:, 1::2] = np.cos(position * div_term)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        return self.drop(x + self.pe[None, : x.shape[1]], rng)


class SelfAttention(nn.Module):
    """Single-head QKV self-attention (reference sublayer.py:46-82).

    out_i = sum_j softmax_j((x_i Wk) . (x_j Wq) / sqrt(att)) (x_j Wv), then a
    bias-free output projection. The reference swaps the usual roles of K and
    Q; the arithmetic is kept as it is. Dropout of rate `dropout` on the
    output."""

    def __init__(
        self, input_size: int, attention_size: int, output_size: int,
        get_pe: bool = False, dtype: torch.dtype = torch.float32, dropout: float = 0.2,
    ):
        super().__init__()
        self.drop = Dropout(dropout)
        self.attention_size = attention_size
        self.dtype = dtype
        # the positional encoding's width is the attention size
        self.pe = PositionalEncoding(attention_size) if get_pe else None
        self.K = Dense(input_size, attention_size, bias=False, dtype=dtype)
        self.Q = Dense(input_size, attention_size, bias=False, dtype=dtype)
        self.V = Dense(input_size, attention_size, bias=False, dtype=dtype)
        self.out = Dense(attention_size, output_size, bias=False, dtype=dtype)

    def forward(self, x, att_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None):
        if self.pe is not None:
            x = self.pe(x, rng)
        K, Q, V = self.K(x), self.Q(x), self.V(x)
        logits = matmul_f32(K, Q.transpose(1, 2)) / math.sqrt(self.attention_size)
        if att_mask is not None:
            logits = torch.where(att_mask > 0, logits, torch.full_like(logits, NEG_FILL))
        weight = torch.softmax(logits, dim=-1)
        attention = matmul_f32(weight.to(self.dtype), V)
        return self.drop(self.out(attention).float(), rng)


class AttentionShare(nn.Module):
    """Single-query cross attention of the decoder (reference sublayer.py:10-43).

    Returns (context [B, out], alpha [B, P]). The K/V projections depend only
    on the proposals, so `precompute` runs them once per sequence."""

    def __init__(
        self, input_value_size: int, input_key_size: int, output_size: int,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.output_size = output_size
        self.dtype = dtype
        self.K = Dense(input_value_size, output_size, bias=False, dtype=dtype)
        self.Q = Dense(input_key_size, output_size, bias=False, dtype=dtype)
        self.V = Dense(input_value_size, output_size, bias=False, dtype=dtype)
        self.out = Dense(output_size, output_size, bias=False, dtype=dtype)
        self.ln = LayerNorm(output_size)
        # the decoder's fused step applies it to both branches at once
        self.drop = Dropout(0.1)

    def precompute(self, meta_state) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K, V) [B, P, out] of the loop-invariant proposal tensor."""
        return self.K(meta_state), self.V(meta_state)

    def step_weights(self):
        """(Q kernel [in, out], out kernel [out, out], ln scale, ln bias) in
        fp32, for the decoder's branch-fused step."""
        return self.Q.kernel(), self.out.kernel(), self.ln.weight, self.ln.bias

    def attend(self, K, V, hidden_previous, rng: Optional[torch.Generator] = None):
        """One attention step over precomputed K/V."""
        q = self.Q(hidden_previous)
        logits = matmul_f32(K, q.unsqueeze(-1)).squeeze(-1) / math.sqrt(self.output_size)
        alpha = torch.softmax(logits, dim=1)  # over proposals
        context = matmul_f32(alpha.to(self.dtype).unsqueeze(1), V).squeeze(1)
        context = torch.tanh(self.out(context).float())
        return self.drop(self.ln(context), rng), alpha

    def forward(self, meta_state, hidden_previous, rng: Optional[torch.Generator] = None):
        K, V = self.precompute(meta_state)
        return self.attend(K, V, hidden_previous, rng)


class LatentPSL(nn.Module):
    """Latent proposal pooling (reference sublayer.py:176-198):
    adj = softmax over the sequence axis of x @ theta^T; out = adj^T @ x,
    then Tanh -> LayerNorm -> Dropout(0.3). Pools [B, T, D] -> [B, num_psl, D]."""

    def __init__(self, input_size: int, num_psl: int):
        super().__init__()
        self.theta = nn.Parameter(torch.empty(num_psl, input_size))
        self.ln = LayerNorm(input_size)
        self.drop = Dropout(0.3)

    def reset_parameters(self, generator=None) -> None:
        xavier_uniform_gain_(self.theta.data, TANH_GAIN, generator)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        x = x.float()  # jnp.einsum promotes a bf16 x against the fp32 theta
        adj = torch.softmax(torch.matmul(x, self.theta.t()), dim=1)  # [B, T, P]
        out = torch.matmul(adj.transpose(1, 2), x)  # [B, P, D]
        return self.drop(self.ln(torch.tanh(out)), rng)


class TanhLayerNorm(nn.Module):
    """`Sequential(Tanh, LayerNorm)`; `dtype` is the LayerNorm's output dtype
    (statistics stay fp32)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln = LayerNorm(dim, out_dtype=dtype)

    def forward(self, x):
        return self.ln(torch.tanh(x))


class Conv1d(nn.Module):
    """flax `nn.Conv(kernel_size=(k,), padding="SAME")` over the time axis of
    [B, T, C], fp32, with a bias: cross-correlation, no flip. The weight is
    torch `Conv1d`'s [out, in, k] (weights.py maps flax's [k, in, out]).

    Computed as one product of the k shifted windows with the kernel, so it
    is exact fp32 on every device (cuDNN would run an fp32 convolution in
    TF32 by default). Remat's "dots" policy computes it again, as JAX's
    `dots_saveable` does a convolution (ops/remat.py)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator=None) -> None:
        # flax's default lecun_normal: fan_in counts the window
        trunc_normal_fan_(self.weight.data, self.weight.shape[1] * self.weight.shape[2], generator)
        self.bias.data.zero_()

    def forward(self, x):
        out_f, in_f, k = self.weight.shape
        T = x.shape[1]
        left = (k - 1) // 2  # SAME: the extra pad of an even kernel goes right
        xp = torch.nn.functional.pad(x, (0, 0, left, k - 1 - left))
        cols = torch.cat([xp[:, i : i + T] for i in range(k)], dim=-1)  # [B, T, k*in]
        w = self.weight.permute(2, 1, 0).reshape(k * in_f, out_f)  # flax [k, in, out]
        with not_a_dot():  # a convolution in JAX: remat "dots" does not keep it
            return torch.matmul(cols, w) + self.bias


class ResBlock(nn.Module):
    """relu(x) + 0.3 * Conv1d(relu(x), k=3, same) over the time axis
    (reference sublayer.py:107-119), on [B, T, C].

    The reference's `nn.ReLU(True)` is in place: it overwrites the residual
    input before the add, so the block it trains is `relu(x) + ...`, not
    `x + ...` (DESIGN.md:184-189); kept as it is."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3)

    def forward(self, x):
        h = torch.relu(x)
        return h + 0.3 * self.conv(h)


class JointEmbedVideoModel2(nn.Module):
    """Score head: Linear(Tanh(Wv v) * Tanh(Ws s)) -> 1 (reference
    sublayer.py:292-306). fp32 Denses."""

    def __init__(self, visual_size: int, sent_size: int, hidden_size: int):
        super().__init__()
        self.visual_embed = Dense(visual_size, hidden_size)
        self.sent_embed = Dense(sent_size, hidden_size)
        self.classify = Dense(hidden_size, 1)

    def forward(self, visual, sent):
        v = torch.tanh(self.visual_embed(visual))
        s = torch.tanh(self.sent_embed(sent))
        return self.classify(v * s)
