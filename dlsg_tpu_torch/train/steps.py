"""Train steps (counterpart of `dlsg_tpu/train/steps.py`; reference
run_gun.py:147-234 and run_graph.py:109-134).

- CE step: teacher-forced generator forward, masked CE, one Adam update, for
  the generators that take (frames, regions, captions) and return a tuple
  (CapGnnModel, CapBaseline1, CapBaselineModel); the frames-only CapModel
  has its own, `make_legacy_ce_train_step` (RunLegacy's step in the JAX
  package, reference run.py). A parameter the loss does not reach (the
  object branch of CapBaselineModel) gets a zero gradient, as under
  jax.grad: its Adam moments stay zero and it does not move.
- GAN step: a generator forward with its outputs detached for the D phase;
  `num_D_visual` WGAN-GP discriminator substeps, each scoring real | fake in
  one `groups=2` pass and running the gradient penalty separately at B; then
  the generator update with cap_loss + lambda * (-D(fake)), lambda from the
  on-device state machine fed with this step's cap_loss.

Gradients are taken with `torch.autograd.grad` against each state's own
parameter list, so the generator head never writes D's gradients and the D
loss never writes G's. A step's random draws (dropout masks, the
scheduled-sampling coins, the penalty's mixing weights) come from one
`torch.Generator` on the models' device, seeded from (key, step). The steps
switch the models to training mode and restore their modes after.

Remat (ops/remat.py): `cfg.decoder_remat` selects what the generator's
teacher-forced scan keeps for its backward (models/decoder.py), and
`cfg.disc_remat` what D's grouped real | fake pass of each substep keeps,
as JAX checkpoints `apply_d2`; the penalty's pass at B, which takes a double
backward, is never rematerialized. Either way the gradients are the same
and every random draw is the one it would be without remat.

Data parallelism (parallel/dist.py): on every rank the losses are that
rank's shares of the global batch's losses (ops/losses.py), each gradient
list is summed over the ranks before its update (`all_reduce_grads`, one
collective: DDP's reducer hooks `.backward()` and would see nothing of
`torch.autograd.grad`), so the optimizer's elementwise clamp sees the global
gradient as optax's chain does. The lambda state machine is fed the global
cap loss and the metrics are global, so every rank keeps the same state.
Every rank runs the same collectives in the same order. Without a process
group all of this is the single-process step.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.models.generator import CapModel
from dlsg_tpu_torch.ops.losses import (
    GP_WEIGHT,
    batch_share,
    gradient_penalty,
    masked_cross_entropy,
    to_onehot,
    wgan_g_loss,
)
from dlsg_tpu_torch.ops.remat import remat
from dlsg_tpu_torch.parallel.dist import all_reduce_grads, global_sum, rank_block_rand
from dlsg_tpu_torch.train.gan_lambda import LambdaState, lambda_update
from dlsg_tpu_torch.train.optim import TrainState

Metrics = Dict[str, torch.Tensor]


def make_masks(captions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """seq mask (captions > 0) and its outer-product attention mask
    (run_gun.py:164-166)."""
    seq_mask = (captions > 0).float()
    return seq_mask, seq_mask[:, :, None] * seq_mask[:, None, :]


def step_generator(key: int, step: int, device) -> torch.Generator:
    """The generator of step `step` under seed `key`, on `device`."""
    seed = np.random.SeedSequence([key, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


@contextlib.contextmanager
def _training(*modules: nn.Module):
    modes = [m.training for m in modules]
    for m in modules:
        m.train()
    try:
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _batch(batch: Mapping[str, Any], device, keys=("frames", "regions", "captions", "lengths")
           ) -> List[torch.Tensor]:
    """The batch's `keys` as tensors on `device`, captions as int64."""
    return [torch.as_tensor(batch[k], device=device).long() if k == "captions"
            else torch.as_tensor(batch[k], device=device) for k in keys]


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d (global loss) / d params: this rank's gradient of its share, summed
    over the ranks; a parameter the loss does not reach gets zeros, as under
    jax.grad."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return all_reduce_grads(grads)


def _ce_step(model: nn.Module, keys: Sequence[str], logits):
    """step(state, batch, key, epsilon) -> (state, {"cap_loss",
    "sample_tokens"}), the logits from `logits(*tensors of keys, epsilon,
    rng)` in training mode."""

    def step(state: TrainState, batch: Mapping[str, Any], key: int, epsilon: float):
        dev = _device(model)
        inputs = _batch(batch, dev, keys)
        captions, lengths = inputs[-2:]
        rng = step_generator(key, state.step, dev)
        with _training(model):
            out = logits(*inputs[:-1], epsilon, rng)
        loss = masked_cross_entropy(out, captions, lengths)
        state.apply_gradients(_grads(loss, state.params))
        return state, {"cap_loss": global_sum(loss.detach()),
                       "sample_tokens": out[0].detach().argmax(-1)}

    return step


def make_ce_train_step(model: nn.Module, cfg: DLSGConfig):
    """CE-only generator step of a (frames, regions, captions) generator:
    step(state, batch, key, epsilon) -> (state, {"cap_loss",
    "sample_tokens"})."""
    if isinstance(model, CapModel):  # (frames, captions) -> logits alone
        raise TypeError("CapModel takes no region features: its CE step is "
                        "make_legacy_ce_train_step")
    return _ce_step(model, ("frames", "regions", "captions", "lengths"),
                    lambda frames, regions, captions, epsilon, rng:
                    model(frames, regions, captions, epsilon, rng=rng)[0])


def make_legacy_ce_train_step(model: nn.Module, cfg: DLSGConfig):
    """The frames-only CapModel's CE step (RunLegacy's in the JAX package,
    reference run.py): the same step without region features."""
    return _ce_step(model, ("frames", "captions", "lengths"),
                    lambda frames, captions, epsilon, rng: model(frames, captions, epsilon, rng=rng))


def make_gan_train_step(gen_model: nn.Module, disc_model: nn.Module, cfg: DLSGConfig):
    """The D-LSG adversarial step:

        step(gen_state, disc_state, lstate, batch, key, epsilon, eps_gp=None)
          -> (gen_state, disc_state, lstate, metrics)

    `eps_gp` [num_D_visual, B], when given, replaces the penalty's mixing
    weights that the step would draw (tests feed JAX's draw). With
    `cfg.gan_single_forward` one generator forward serves both phases: the D
    phase sees its outputs detached and the G gradient is pulled back
    through the same forward after the D phase. Otherwise the G phase runs a
    second forward with its own draw. Both `cfg.gan_gp_custom_vjp` values
    take the one penalty implementation (ops/losses.py). Metrics are device
    tensors: cap_loss, loss_G, loss_D, wasserstein and grad_penalty (the
    last three averaged over the substeps), global over the ranks;
    gan_lambda; sample_tokens (this rank's first row). Under a process group
    `eps_gp` holds this rank's rows."""
    vocab_size = gen_model.vocab_size
    num_d = cfg.num_D_visual
    single_fwd = cfg.gan_single_forward

    def step(
        gen_state: TrainState,
        disc_state: TrainState,
        lstate: LambdaState,
        batch: Mapping[str, Any],
        key: int,
        epsilon: float,
        eps_gp: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, TrainState, LambdaState, Metrics]:
        dev = _device(gen_model)
        frames, regions, captions, lengths = _batch(batch, dev)
        _, att_mask = make_masks(captions)
        r_caption = to_onehot(captions, vocab_size)
        B = captions.shape[0]
        rng = step_generator(key, gen_state.step, dev)

        with _training(gen_model, disc_model):
            # ---- D phase: the generator's outputs, detached (run_gun.py:167-178)
            with torch.set_grad_enabled(single_fwd):
                out, obj, mot, alpha = gen_model(frames, regions, captions, epsilon, rng=rng)
            f_caption, obj, mot, alpha = (t.detach() for t in (out, obj, mot, alpha))
            obj2, mot2, att2, alpha2 = (
                torch.cat([t, t], dim=0) for t in (obj, mot, att_mask, alpha)
            )
            real_fake = torch.cat([r_caption, f_caption], dim=0)

            def d_fn(caps):
                return disc_model(caps, obj, mot, att_mask, alpha, rng=rng)

            # real | fake in one grouped pass, under cfg.disc_remat (the
            # penalty's pass at B is never rematerialized, as in JAX)
            d_grouped = remat(
                lambda caps, rng: disc_model(caps, obj2, mot2, att2, alpha2, groups=2, rng=rng),
                cfg.disc_remat, rng, module=disc_model,
            )

            d_stats = []
            for i in range(num_d):
                if eps_gp is None:
                    eps = rank_block_rand((B, 1, 1), rng, dev)
                else:
                    eps = torch.as_tensor(eps_gp[i], dtype=torch.float32, device=dev)
                eps = eps.reshape(B, 1, 1).to(r_caption.dtype)
                scores = d_grouped(real_fake)
                r_loss, f_loss = batch_share(scores[:B]), batch_share(scores[B:])
                gp = gradient_penalty(d_fn, r_caption, f_caption, eps)
                loss_d = f_loss - r_loss + GP_WEIGHT * gp
                disc_state.apply_gradients(_grads(loss_d, disc_state.params))
                d_stats.append(torch.stack([loss_d, r_loss - f_loss, gp]).detach())

            # ---- G phase (run_gun.py:183,215-218): D scores the raw logits;
            # proposals and alpha stay detached
            if not single_fwd:
                out, obj, mot, alpha = gen_model(frames, regions, captions, epsilon, rng=rng)
                obj, mot, alpha = obj.detach(), mot.detach(), alpha.detach()
            cap_loss = masked_cross_entropy(out, captions, lengths)
            loss_g = wgan_g_loss(disc_model(out, obj, mot, att_mask, alpha, rng=rng))

        # the global losses in one collective: cap, G, then the substeps' D stats
        totals = global_sum(torch.cat([torch.stack([cap_loss, loss_g]).detach(),
                                       torch.stack(d_stats).reshape(-1)]))
        lstate, gan_lambda = lambda_update(lstate, totals[0])
        gen_state.apply_gradients(_grads(cap_loss + gan_lambda * loss_g, gen_state.params))
        loss_d, wasserstein, gp = totals[2:].reshape(num_d, 3).mean(dim=0)
        metrics = {
            "cap_loss": totals[0],
            "loss_G": totals[1],
            "loss_D": loss_d,
            "wasserstein": wasserstein,
            "grad_penalty": gp,
            "gan_lambda": gan_lambda,
            "sample_tokens": out[0].detach().argmax(-1),
        }
        return gen_state, disc_state, lstate, metrics

    return step
