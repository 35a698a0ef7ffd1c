"""Rematerialization of a train step's pieces: what the backward keeps of a
function and what it computes again (counterpart of `nn.remat` in
`dlsg_tpu/models/decoder.py:376-390` and `jax.checkpoint` in
`dlsg_tpu/train/steps.py:191-206`).

`remat(fn, policy, rng)` wraps `fn(*args, rng=generator)`:
- "none": `fn` with `rng` as it is; the autograd graph keeps what it needs;
- "full" (JAX's `nothing_saveable`): `torch.utils.checkpoint.checkpoint`,
  non-reentrant: the backward keeps the inputs and runs `fn` again;
- "dots" (JAX's `dots_saveable`): the same with a selective-checkpoint
  policy that keeps the outputs of the matrix products (`aten.mm`, `addmm`,
  `bmm`, `baddbmm`: what Linear, matmul and einsum dispatch to) and computes
  the rest again. A convolution is no dot in JAX (`conv_general_dilated` is
  not `dot_general`); the port computes `layers.Conv1d` as a product, which
  runs under `not_a_dot()` so that it too is computed again.

Non-reentrant, because the train steps take their gradients with
`torch.autograd.grad`, which reentrant checkpointing does not support.

The generator. Dropout and the penalty draw from an explicit
`torch.Generator` (ops/linear.py::dropout), and `checkpoint`'s
`preserve_rng_state` restores only the default generators: a plain
recompute would draw new masks, and advance the caller's generator a second
time. So the forward draws from `rng` itself, which ends where one forward
leaves it, and the recompute, once, from a fork of `rng` taken where the
forward began (utils/cuda_graph.py::fork, also inside a CUDA graph), which
draws the same masks again. The package draws nothing from the default
generators. With `module` given, the recompute also runs in the
training mode that module had in the forward: a step's backward may run
after its modules went back to eval mode.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from dlsg_tpu_torch.utils.cuda_graph import fork

POLICIES = ("none", "dots", "full")

_DOTS = frozenset(
    (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm)
)

_not_dot = threading.local()


@contextlib.contextmanager
def not_a_dot():
    """Products run inside this block are no dots to the "dots" policy (a
    convolution computed as a product)."""
    depth = getattr(_not_dot, "depth", 0)
    _not_dot.depth = depth + 1
    try:
        yield
    finally:
        _not_dot.depth = depth


def _save_dots(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    if getattr(func, "_overloadpacket", None) in _DOTS and not getattr(_not_dot, "depth", 0):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


@contextlib.contextmanager
def _mode(module: Optional[nn.Module], training: Optional[bool]):
    """Every submodule of `module` in `training` mode while the block runs,
    each put back as it was after."""
    if module is None or all(m.training == training for m in module.modules()):
        yield
        return
    modes = [(m, m.training) for m in module.modules()]
    module.train(training)
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


def remat(fn: Callable, policy: str, rng: Optional[torch.Generator],
          module: Optional[nn.Module] = None) -> Callable:
    """`fn(*args, rng=...)` as a callable of `*args` whose backward keeps
    what `policy` says (module doc); same outputs and gradients as `fn`.
    Under no-grad nothing is kept and `fn` runs as it is."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy must be one of {POLICIES}, got {policy!r}")
    if policy == "none":
        return functools.partial(fn, rng=rng)
    context_fn = _dots_context if policy == "dots" else noop_context_fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args, rng=rng)
        again = None if rng is None else fork(rng)
        training = None if module is None else module.training
        runs = []

        def run(*inner):
            local = again if runs else rng  # the recompute, or the forward
            runs.append(1)
            with _mode(module, training):
                return fn(*inner, rng=local)

        return checkpoint(run, *args, use_reentrant=False, context_fn=context_fn,
                          preserve_rng_state=False)

    return wrapped
