"""Building blocks with flax.linen's numerics: Dense, LayerNorm, Embed, their
initializers, and the fp32-output matmul.

Two matmul forms of the JAX package give different output types, and the port
keeps both:
- `jnp.dot(a, b, preferred_element_type=float32)` multiplies operands rounded
  to their dtype and returns fp32: `matmul_f32` here;
- flax `nn.Dense(dtype=bf16)` returns bf16: `Dense` here.

`dropout` is flax's `nn.Dropout` on an explicit generator; `Dropout` is a
site of it inside a module. Under a process group each rank draws its mask
as its block of one draw over the ranks (parallel/dist.py): the ranks' masks
are independent, and world size 1 draws the single-process mask.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlsg_tpu_torch.parallel.dist import rank_block_rand

# torch nn.LayerNorm's default eps, pinned on every LayerNorm of the model
LN_EPS = 1e-5

# flax's truncated-normal initializers draw from N(0, 1) cut at +-2 and
# rescale by this constant so the variance is the requested one
_TRUNC_STD = 0.87962566103423978


def _bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:  # the tensor cores, fp32 accumulation and output
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """bf16 x bf16 -> fp32 product with JAX's transpose rule for
    `dot(..., preferred_element_type=float32)`: the fp32 cotangent times the
    other operand upcast to fp32, cast back to the operand's dtype.

    The backward is built from differentiable fp32 products, so it can be
    differentiated again (the gradient penalty's double backward). A
    function of its own because `torch.mm(..., out_dtype=...)` has no
    autograd formula."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bf16_product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product of `a` and `b` as given (2-D or batched 3-D): bf16
    operands are multiplied exactly and accumulated in fp32.

    Two bf16 operands of the same rank (2-D, or 3-D with one batch size) go
    through `_MatmulF32`: on a card the tensor cores with an fp32 output,
    elsewhere the upcast product, which computes the same function; the
    gradient is JAX's on every device. Other operands are upcast."""
    if (
        a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
        and a.dim() == b.dim() and a.dim() in (2, 3)
        and (a.dim() == 2 or a.shape[0] == b.shape[0])
    ):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return _bf16_product(a, b)
    return torch.matmul(a.float(), b.float())


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); identity when `rng` is None
    (deterministic) or rate is 0. The mask is drawn from `rng`, a generator
    on x's device, never from the global RNG, as this rank's block
    (`rank_block_rand`). Every dropout site of the package calls this one
    function."""
    if rng is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = rank_block_rand(x.shape, rng, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """A dropout site with its (hard-coded or configured) rate: `dropout`
    in training mode when the call passes a generator, identity otherwise."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, rng if self.training else None)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


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
    output comes back in `dtype`. Weight is stored as [out, in] in fp32.

    Split over a mesh's model axis (`parallel/mesh.py::shard_params`), it
    holds the rows of its output columns `out_shard[0]` onward, of
    `out_shard[1]` in all, and its user gathers the output (the vocab head:
    `DecoderStep.vocab_logits`); `out_shard` is None for a whole layer."""

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
        self.out_shard: Optional[Tuple[int, int]] = None

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
