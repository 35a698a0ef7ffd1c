"""Building blocks with flax.linen's numerics: Dense, LayerNorm, Embed, their
initializers, and the fp32-output matmul.

Two matmul forms of the JAX package give different output types, and the port
keeps both:
- `jnp.dot(a, b, preferred_element_type=float32)` multiplies operands rounded
  to their dtype and returns fp32: `matmul_f32` here;
- flax `nn.Dense(dtype=bf16)` returns bf16: `Dense` here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# torch nn.LayerNorm's default eps, pinned on every LayerNorm of the model
LN_EPS = 1e-5

# flax's truncated-normal initializers draw from N(0, 1) cut at +-2 and
# rescale by this constant so the variance is the requested one
_TRUNC_STD = 0.87962566103423978


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product of `a` and `b` as given (2-D or batched 3-D): bf16
    operands are multiplied exactly and accumulated in fp32.

    On a card, bf16 operands go to the tensor cores with an fp32 output;
    elsewhere the operands are upcast, which computes the same function."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        if a.dim() == 2 and b.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        if a.dim() == 3 and b.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def trunc_normal_fan_(w: torch.Tensor, fan: float, generator=None) -> torch.Tensor:
    """variance_scaling(1.0, fan, 'truncated_normal'): std sqrt(1/fan)."""
    std = math.sqrt(1.0 / fan) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def lecun_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's default Dense kernel init, for a torch weight [out, in]."""
    return trunc_normal_fan_(w, w.shape[1], generator)


def xavier_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax `initializers.xavier_normal()` (fan_avg, truncated normal)."""
    return trunc_normal_fan_(w, (w.shape[0] + w.shape[1]) / 2.0, generator)


class Dense(nn.Module):
    """flax `nn.Dense`: input, weight and bias are cast to `dtype` and the
    output comes back in `dtype`. Weight is stored as [out, in] in fp32."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
        kernel_init: str = "lecun_normal",
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        init = xavier_normal_ if self.kernel_init == "xavier_normal" else lecun_normal_
        init(self.weight.data, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def kernel(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The flax-layout kernel [in, out], cast to `dtype`, contiguous."""
        return self.weight.t().to(dtype or self.weight.dtype).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


def layer_norm(x, scale, bias, out_dtype: Optional[torch.dtype] = None):
    """flax LayerNorm arithmetic: fp32 statistics with var = E[x^2] - mu^2
    clamped at 0, then (x - mu) * (rsqrt(var + eps) * scale) + bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + LN_EPS) * scale) + bias
    return y if out_dtype is None else y.to(out_dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(epsilon=1e-5, dtype=out_dtype)` over the last axis.
    The output is fp32 unless `out_dtype` is given."""

    def __init__(self, dim: int, out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.out_dtype)


class Embed(nn.Module):
    """flax `nn.Embed`; the table keeps flax's parameter name `embedding`."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator=None) -> None:
        # flax default_embed_init: variance_scaling(1, 'fan_in', 'normal', out_axis=0)
        nn.init.normal_(
            self.embedding.data, 0.0, 1.0 / math.sqrt(self.embedding.shape[1]),
            generator=generator,
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize `module` and every submodule that defines
    `reset_parameters(generator)`, in registration order, from one generator."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
