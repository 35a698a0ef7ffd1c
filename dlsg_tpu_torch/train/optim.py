"""Optimizer and train state (counterpart of `dlsg_tpu/train/optim.py`).

Reference setup (run_gun.py:91-104): Adam(lr=1.6e-4, betas=(0.5, 0.9)) for
the generator and the discriminator, MultiStepLR milestones [4, 7] (G) and
[1, 4] (D), gamma 0.5, stepped per epoch. `torch.optim.Adam` with eps 1e-8
outside the square root and bias correction is optax's `adam`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float, epoch: int) -> float:
    """torch MultiStepLR semantics: lr = base * gamma^|{m : m <= epoch}|."""
    n = sum(1 for m in milestones if m <= epoch)
    return base_lr * (gamma**n)


@dataclass(frozen=True)
class AdamConfig:
    """What `make_optimizer` describes; `TrainState.create` builds it."""

    learning_rate: float
    grad_clip: float = 0.0
    frozen_paths: Tuple[str, ...] = ()

    def is_frozen(self, name: str) -> bool:
        """A parameter is frozen when any component of its name is a frozen
        path (the JAX package matches flax path components the same way)."""
        return any(part in self.frozen_paths for part in name.split("."))


def make_optimizer(
    learning_rate: float, grad_clip: float = 0.0, frozen_paths: Sequence[str] = ()
) -> AdamConfig:
    """Adam with the reference betas (0.5, 0.9).

    grad_clip > 0 clamps each gradient element to [-c, c] before Adam
    (optax.clip; reference `clip_gradient`, utils/utils.py:46-50), which is
    not a norm clip. Parameters under `frozen_paths` (e.g. "word_embed")
    get no gradient, no update and no moments."""
    return AdamConfig(learning_rate, grad_clip, tuple(frozen_paths))


@dataclass
class TrainState:
    """A module with its Adam optimizer and step count. The step functions
    update it in place and return it."""

    module: nn.Module
    optimizer: torch.optim.Adam
    config: AdamConfig
    names: List[str]  # the trained parameters, in `params` order
    params: List[nn.Parameter]
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, config: AdamConfig) -> "TrainState":
        named = [(n, p) for n, p in module.named_parameters() if not config.is_frozen(n)]
        params = [p for _, p in named]
        opt = torch.optim.Adam(params, lr=config.learning_rate, betas=(0.5, 0.9), eps=1e-8)
        return cls(module, opt, config, [n for n, _ in named], params)

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        """One Adam update from `grads`, one per entry of `params`."""
        clip = self.config.grad_clip
        for p, g in zip(self.params, grads, strict=True):
            p.grad = g.clamp(-clip, clip) if clip > 0 else g
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        self.step += 1
        return self

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment (optax `mu`) of each trained parameter, zeros
        before its first update."""
        return {
            n: self.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            for n, p in zip(self.names, self.params)
        }

    def set_learning_rate(self, lr: float) -> "TrainState":
        """Per-epoch learning rate (the MultiStepLR counterpart)."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self
