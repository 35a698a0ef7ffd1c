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
  on-device state machine fed with this step's cap_loss. While a
  `torch.profiler` trace runs, its phases are spans (utils/profiler.py):
  `dlsg.gan.g_forward` (the D phase's generator forward), `dlsg.gan.d_substep`
  (each substep; args its index) holding `dlsg.gan.penalty`, and
  `dlsg.gan.g_update` (G's losses, lambda, gradient and update).

The GAN step from CUDA graphs. On a card, with no data axis and the step's
own penalty draws (`step_graph_engaged`), the step runs as one CUDA graph
(utils/cuda_graph.py), replayed once a step: G's forward, the
`num_D_visual` D substeps (the mixing weights' draw, the grouped real |
fake pass, the penalty with its double backward, D's gradient and Adam
update), G's losses, lambda, G's gradient and Adam update, under either
remat. The graph launches the kernels that the eager step launches, on the
same data, without the host dispatching each. It reads the batch and the
lambda state from buffers of its own, into which each step copies them,
hands back clones of its outputs (so a caller's late read of a step's
metrics sees that step's), and follows the step's generator: one generator
per device for the step function's life (`StepRng`), re-seeded each step,
so every draw, a remat region's recompute among them, lands where the
eager step's would. The graph bakes in what its key names
(`_step_graph_key`): the inputs' shapes, the Adam settings (learning rates
among them) and clamps, the teacher-forcing ratio, the modes, the substep
count, the tensors it updates and the functions it calls. A step under a
key that has no graph yet (the step function's first, or after the
trainer's learning-rate milestones or epsilon schedule changed the key) runs
eager, as the graph's warm-up, which also makes Adam's state, and then
captures the graph, dropping the last one and freeing its pool; every later
step under that key replays. The graphed states' Adam turns `capturable`
(train/optim.py), which moves its step count to the card. Everything else
runs the eager loop; the CPU always does. While a trace runs, the counters
`gan.steps` and `gan.steps_graphed` count the steps and the replays,
`gan.d_substeps` and `gan.d_substeps_graphed` the substeps and those a
replay ran (`num_D_visual` a replay); a replay is the span
`dlsg.gan.step_replay`, so the phase spans above, `dlsg.gan.penalty` and
`dlsg.optim.update` then appear only in eager steps and at a capture.

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
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

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
from dlsg_tpu_torch.parallel.dist import (
    all_reduce_grads,
    data_axis_active,
    global_sum,
    rank_block_rand,
)
from dlsg_tpu_torch.train.gan_lambda import LambdaState, lambda_update
from dlsg_tpu_torch.train.optim import TrainState
from dlsg_tpu_torch.utils import cuda_graph
from dlsg_tpu_torch.utils.profiler import count, span

Metrics = Dict[str, torch.Tensor]


def make_masks(captions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """seq mask (captions > 0) and its outer-product attention mask
    (run_gun.py:164-166)."""
    seq_mask = (captions > 0).float()
    return seq_mask, seq_mask[:, :, None] * seq_mask[:, None, :]


def step_seed(key: int, step: int) -> int:
    """The seed of step `step`'s draws under seed `key`."""
    return int(np.random.SeedSequence([key, step]).generate_state(1, np.uint64)[0])


def step_generator(key: int, step: int, device) -> torch.Generator:
    """The generator of step `step` under seed `key`, on `device`."""
    return torch.Generator(device=device).manual_seed(step_seed(key, step))


class StepRng:
    """One generator per device for a step function's life, re-seeded at
    each step: it draws what `step_generator(key, step, device)` draws, and
    stays the one object that a CUDA graph follows."""

    def __init__(self) -> None:
        self._gens: Dict[torch.device, torch.Generator] = {}

    def __call__(self, key: int, step: int, device) -> torch.Generator:
        device = torch.device(device)
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        return gen.manual_seed(step_seed(key, step))


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


def step_graph_engaged(device, cfg: DLSGConfig, eps_gp: Optional[torch.Tensor]) -> bool:
    """Whether a GAN step replays from a CUDA graph (module doc): on a card,
    with no data axis (its all-reduce would sit inside the capture) and the
    step's own penalty draws (`eps_gp` None)."""
    return torch.device(device).type == "cuda" and not data_axis_active() and eps_gp is None


def _state_key(state: TrainState) -> tuple:
    """What a graph bakes in of a train state: its Adam settings (the
    learning rate among them), its clamp, and the tensors it updates
    (parameters and Adam state, by address)."""
    opt = state.optimizer
    return (
        tuple(tuple((k, v) for k, v in g.items() if k != "params") for g in opt.param_groups),
        state.config.grad_clip,
        tuple(p.data_ptr() for p in state.params),
        tuple(t.data_ptr() for p in state.params for t in opt.state.get(p, {}).values()),
    )


def _step_graph_key(gen_state: TrainState, disc_state: TrainState,
                    inputs: Sequence[torch.Tensor], rng: torch.Generator, num_d: int,
                    epsilon: float, single_fwd: bool) -> tuple:
    """What a captured GAN step bakes in: its inputs' shapes and layouts
    (the batch and the lambda state), both states (`_state_key`) and modes,
    the generator it follows, the substep count, the teacher-forcing ratio,
    the forward's sharing, and the functions it calls, as the step finds
    them now."""
    return (
        tuple((t.shape, t.stride(), t.dtype, t.device) for t in inputs),
        _state_key(gen_state), _state_key(disc_state),
        gen_state.module.training, disc_state.module.training,
        rng, num_d, float(epsilon), single_fwd,
        batch_share, gradient_penalty, type(disc_state).apply_gradients, _grads,
        masked_cross_entropy, wgan_g_loss, lambda_update,
    )


def _cloned(out):
    """A tensor, or a tuple or dict of them, cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _cloned(v) for k, v in out.items()}
    return tuple(_cloned(v) for v in out)


class _KeyedGraph:
    """The GAN step as a CUDA graph made under a key (module doc): a step
    under a new key runs eager as the graph's warm-up and then captures it,
    dropping the last graph and giving its pool back to the card; a step
    under the same key replays it."""

    def __init__(self) -> None:
        self.key: Optional[tuple] = None  # what the graph was made under
        self.graph: Optional[cuda_graph.Graph] = None
        self.inputs: Tuple[torch.Tensor, ...] = ()  # the graph's own input buffers

    def run(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor], rng: torch.Generator,
            key_fn: Callable[[], tuple]) -> Tuple[Any, bool]:
        """`fn(*inputs)` (tensors, or a tuple or dict of them) as the class
        doc says: (fn's outputs, whether the graph ran them)."""
        if key_fn() == self.key:
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)
            with span("gan.step_replay"):
                return _cloned(self.graph.replay()), True
        if self.graph is not None:
            self.graph = None
            # a dropped graph's pool goes back to the card only here: the
            # allocator never frees it inside the next capture
            torch.cuda.empty_cache()
        graph = cuda_graph.Graph(inputs[0].device, rng)
        out = graph.warm_up(lambda: fn(*inputs))
        self.key = key_fn()  # after the warm-up: Adam's state exists now
        self.inputs = tuple(t.clone() for t in inputs)
        graph.capture(lambda: fn(*self.inputs))
        self.graph = graph
        return out, False


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
    step_rng = StepRng()
    step_graph = _KeyedGraph()

    def work(gen_state: TrainState, disc_state: TrainState, lstate: LambdaState,
             frames, regions, captions, lengths, epsilon: float, rng: torch.Generator,
             eps_gp: Optional[torch.Tensor] = None) -> Tuple[LambdaState, Metrics]:
        """The step on the batch's device tensors: (lstate, metrics)."""
        dev = frames.device
        _, att_mask = make_masks(captions)
        r_caption = to_onehot(captions, vocab_size)
        B = captions.shape[0]

        # ---- D phase: the generator's outputs, detached (run_gun.py:167-178)
        with span("gan.g_forward"), torch.set_grad_enabled(single_fwd):
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
            with span("gan.d_substep", i):
                if eps_gp is None:
                    eps = rank_block_rand((B, 1, 1), rng, dev)
                else:
                    eps = torch.as_tensor(eps_gp[i], dtype=torch.float32, device=dev)
                eps = eps.reshape(B, 1, 1).to(r_caption.dtype)
                scores = d_grouped(real_fake)
                r_loss, f_loss = batch_share(scores[:B]), batch_share(scores[B:])
                with span("gan.penalty"):
                    gp = gradient_penalty(d_fn, r_caption, f_caption, eps)
                loss_d = f_loss - r_loss + GP_WEIGHT * gp
                disc_state.apply_gradients(_grads(loss_d, disc_state.params))
                d_stats.append(torch.stack([loss_d, r_loss - f_loss, gp]).detach())

        # ---- G phase (run_gun.py:183,215-218): D scores the raw logits;
        # proposals and alpha stay detached
        with span("gan.g_update"):
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
        return lstate, {
            "cap_loss": totals[0],
            "loss_G": totals[1],
            "loss_D": loss_d,
            "wasserstein": wasserstein,
            "grad_penalty": gp,
            "gan_lambda": gan_lambda,
            "sample_tokens": out[0].detach().argmax(-1),
        }

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
        inputs = _batch(batch, dev)
        rng = step_rng(key, gen_state.step, dev)

        with _training(gen_model, disc_model):
            if step_graph_engaged(dev, cfg, eps_gp):
                for state in (gen_state, disc_state):
                    if not state.capturable:
                        state.set_capturable(True)
                names = sorted(lstate)
                step_inputs = (*inputs, *(lstate[k] for k in names))

                def whole(frames, regions, captions, lengths, *lvalues):
                    return work(gen_state, disc_state, dict(zip(names, lvalues)),
                                frames, regions, captions, lengths, epsilon, rng)

                def key_fn():
                    return _step_graph_key(gen_state, disc_state, step_inputs, rng, num_d,
                                           epsilon, single_fwd)

                # the Adam step counts: a replay runs no Python, a capture updates nothing
                steps = gen_state.step + 1, disc_state.step + num_d
                (lstate, metrics), replayed = step_graph.run(whole, step_inputs, rng, key_fn)
                gen_state.step, disc_state.step = steps
            else:
                (lstate, metrics), replayed = work(gen_state, disc_state, lstate, *inputs,
                                                   epsilon, rng, eps_gp), False

        count("gan.steps")
        count("gan.d_substeps", num_d)
        count("gan.steps_graphed", int(replayed))  # the shares read 0 where no graph runs
        count("gan.d_substeps_graphed", num_d * replayed)
        return gen_state, disc_state, lstate, metrics

    return step
