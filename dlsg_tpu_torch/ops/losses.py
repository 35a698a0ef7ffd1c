"""Loss functions (counterpart of `dlsg_tpu/ops/losses.py`).

- masked cross-entropy: the mean of -log p(target) over the first `length`
  positions of every sample (reference run_gun.py:189-197);
- WGAN-GP: discriminator loss mean(f) - mean(r) + 10 gp, the penalty by
  `torch.autograd.grad(..., create_graph=True)` through the discriminator
  (run_gun.py:339-383), so the loss's parameter gradient is a double
  backward. The JAX package can also compute that gradient by
  reverse-over-forward (`gan_gp_custom_vjp`); the value is the same, and
  the port has this one implementation;
- generator adversarial loss -mean(D(fake)) (run_gun.py:219);
- the proposal diversity margin loss (run_gun.py:322-336, unused by the
  reference training loop).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

# WGAN-GP penalty weight (run_gun.py:372-375), for every D-loss site
GP_WEIGHT = 10.0


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] float mask (1 where position < length)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()


def masked_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Mean CE over the valid positions, in fp32."""
    mask = length_mask(lengths, targets.shape[1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]  # [B, T]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def to_onehot(seq: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, T] int -> [B, T, V] fp32 one-hot; the pad id is included, as the
    reference's scatter does (run_gun.py:449-453)."""
    return F.one_hot(seq.long(), vocab_size).float()


def _penalty(grads: torch.Tensor) -> torch.Tensor:
    # the norm accumulates in fp32: a bf16 sum of ~260k squares loses it
    norm = grads.reshape(grads.shape[0], -1).float().norm(dim=1)
    return ((norm - 1.0) ** 2).mean()


def _requiring_grad(x: torch.Tensor) -> torch.Tensor:
    return x if x.requires_grad else x.detach().requires_grad_(True)


def gradient_penalty(
    d_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    eps: torch.Tensor,
) -> torch.Tensor:
    """E[(||grad_x D(x_mix)||_2 - 1)^2] at x_mix = real eps + fake (1 - eps)
    (run_gun.py:355-371); eps [B, 1, 1]. Differentiable again: its gradient
    reaches D's parameters and, where they require it, real and fake."""
    mixed = _requiring_grad(real * eps + fake * (1.0 - eps))
    (grads,) = torch.autograd.grad(d_fn(mixed).sum(), mixed, create_graph=True)
    return _penalty(grads)


def wgan_d_loss(
    d_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    eps: torch.Tensor,
    gp_weight: float = GP_WEIGHT,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Discriminator loss f - r + 10 gp: (loss, {"wasserstein": r - f, "gp"})."""
    r_loss = d_fn(real).mean()
    f_loss = d_fn(fake).mean()
    gp = gradient_penalty(d_fn, real, fake, eps)
    return f_loss - r_loss + gp_weight * gp, {"wasserstein": r_loss - f_loss, "gp": gp}


def wgan_d_loss_fused(
    d_fn3: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    eps: torch.Tensor,
    gp_weight: float = GP_WEIGHT,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`wgan_d_loss` in one pass of `d_fn3` over [real | fake | mixed]
    (DiscV2 with groups=3): the penalty's gradient is that of the mixed
    rows' scores alone, since no group's scores depend on another's rows."""
    B = real.shape[0]
    mixed = _requiring_grad(real * eps + fake * (1.0 - eps))
    scores = d_fn3(torch.cat([real, fake, mixed], dim=0))
    r_loss = scores[:B].mean()
    f_loss = scores[B : 2 * B].mean()
    (grads,) = torch.autograd.grad(scores[2 * B :].sum(), mixed, create_graph=True)
    gp = _penalty(grads)
    return f_loss - r_loss + gp_weight * gp, {"wasserstein": r_loss - f_loss, "gp": gp}


def wgan_g_loss(f_logit: torch.Tensor) -> torch.Tensor:
    """Generator adversarial loss: -mean(D(fake))."""
    return -f_logit.mean()


def psl_diversity_loss(psl: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Cosine-embedding margin loss over all unordered proposal pairs,
    target -1, scaled by 0.5."""
    x = psl / (psl.norm(dim=-1, keepdim=True) + 1e-8)
    sim = torch.matmul(x, x.transpose(1, 2))  # [B, P, P]
    P = psl.shape[1]
    iu = torch.triu(torch.ones(P, P, dtype=torch.bool, device=psl.device), diagonal=1)
    pair_loss = (sim - margin).clamp_min(0.0)
    return 0.5 * (pair_loss * iu).sum() / (psl.shape[0] * iu.sum())
