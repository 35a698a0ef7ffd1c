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

The GAN step from CUDA graphs. On a card, with no data axis, the step's own
penalty draws and no remat (`step_graph_engaged`), the step captures itself
whole as one CUDA graph and replays it once a step: G's forward, the
`num_D_visual` D substeps (the mixing weights' draw, the grouped real | fake
pass, the penalty with its double backward, D's gradient and Adam update),
G's losses, lambda, G's gradient and Adam update. The graph launches the
kernels that the eager step launches, on the same data, without the host
dispatching each. Where only G's scan is rematerialized (`d_graph_engaged`),
the step captures one D substep and replays it in place of the eager
substeps instead. Either graph reads its inputs from buffers of its own,
into which each step copies them (the batch and the lambda state; D's, the
detached G outputs and masks), hands back clones of its outputs (so a
caller's late read of a step's metrics sees that step's), and follows the
step's generator: one generator per device for the step function's life
(`StepRng`), re-seeded each step, so every draw lands where the eager
step's would. A graph bakes in what its key names (`_step_graph_key`,
`_d_graph_key`): the inputs' shapes, the Adam settings (learning rates among
them) and clamps, the teacher-forcing ratio, the modes, the substep count,
the tensors it updates and the functions it calls. Both share one flow
(`_KeyedGraph`): the first run of a step function, and any run that would
make Adam's state, is eager; the next run captures and every later one
replays; a new key (the trainer's learning-rate milestones or epsilon
schedule) drops the graph and frees its pool, and the next run captures
anew. The graphed states' Adam turns `capturable` (train/optim.py), which
moves its step count to the card. Everything else runs the eager loop;
the CPU always does. While a trace runs, the counters `gan.steps` and
`gan.steps_graphed` count the steps and the whole-step replays,
`gan.d_substeps` and `gan.d_substeps_graphed` the substeps and those a
graph ran (a step's replay runs `num_D_visual`); a step's replay is the
span `dlsg.gan.step_replay`, so the phase spans above, `dlsg.gan.penalty`
and `dlsg.optim.update` then appear only in eager steps or substeps and at
a capture.

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


def d_graph_engaged(device, cfg: DLSGConfig, eps_gp: Optional[torch.Tensor]) -> bool:
    """Whether a GAN step replays D's substeps from a CUDA graph (module
    doc): on a card, with no data axis (its all-reduce would sit inside the
    capture), the step's own penalty draws (`eps_gp` None) and no remat of
    D's pass (remat moves the generator's state on the host,
    ops/remat.py)."""
    return (torch.device(device).type == "cuda" and not data_axis_active()
            and eps_gp is None and cfg.disc_remat == "none")


def step_graph_engaged(device, cfg: DLSGConfig, eps_gp: Optional[torch.Tensor]) -> bool:
    """Whether a GAN step replays whole from one CUDA graph (module doc):
    where D's graph would engage and G's scan is not rematerialized either
    (`decoder_remat`, for the same reason as D's)."""
    return d_graph_engaged(device, cfg, eps_gp) and cfg.decoder_remat == "none"


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


def _d_graph_key(state: TrainState, inputs: Sequence[torch.Tensor], rng: torch.Generator,
                 num_d: int) -> tuple:
    """What a captured D substep bakes in: its inputs' shapes and layouts,
    D's state (`_state_key`), the modes, the substep count, the generator it
    follows, and the functions it calls, as the step finds them now."""
    return (
        tuple((t.shape, t.stride(), t.dtype, t.device) for t in inputs),
        _state_key(state), state.module.training, num_d, rng,
        batch_share, gradient_penalty, type(state).apply_gradients, _grads,
    )


def _step_graph_key(gen_state: TrainState, disc_state: TrainState,
                    inputs: Sequence[torch.Tensor], rng: torch.Generator, num_d: int,
                    epsilon: float, single_fwd: bool) -> tuple:
    """What a captured GAN step bakes in: D's substep key over the step's
    inputs (the batch and the lambda state), and G's state and mode, the
    teacher-forcing ratio, the forward's sharing and the G phase's
    functions."""
    return _d_graph_key(disc_state, inputs, rng, num_d) + (
        _state_key(gen_state), gen_state.module.training, float(epsilon), single_fwd,
        masked_cross_entropy, wgan_g_loss, lambda_update,
    )


def _capture(fn: Callable[[], Any], rng: torch.Generator) -> Callable[[], Any]:
    """`fn` captured on the current stream (a side stream: the default one
    cannot capture) as a CUDA graph that follows `rng`'s draws; returns its
    replay, which returns fn's outputs: the graph's memory, which each
    replay rewrites. The capture runs nothing. Unlike `torch.cuda.graph`,
    it leaves the allocators' caches as they are: emptying them costs
    set-up time and frees nothing that the graph's own pool could use."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(rng)
    # thread_local: the feed's thread may wait on its own copies meanwhile
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        out = fn()
    finally:
        graph.capture_end()

    def replay():
        graph.replay()
        return out

    return replay


@contextlib.contextmanager
def _on(stream: Optional[torch.cuda.Stream]):
    """Work on `stream` after the current stream's, the current stream
    waiting for it after; without a stream (the CPU), where it is."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def _cloned(out):
    """A tensor, or a tuple or dict of them, cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _cloned(v) for k, v in out.items()}
    return tuple(_cloned(v) for v in out)


class _KeyedGraph:
    """A part of the GAN step as a CUDA graph made under a key (module
    doc): run eager while it warms up (its first run, and any run while a
    state it updates has no Adam state: the first update makes it), then
    captured, then replayed while the key holds; a new key drops the graph
    and gives its pool back to the card, and the next run captures it
    again."""

    def __init__(self, replay_span: Optional[str] = None) -> None:
        self.replay_span = replay_span  # the span around each replay, if any
        self.key: Optional[tuple] = None  # what the graph was made under
        self.warm = False
        self.replay: Optional[Callable[[], Any]] = None
        self.inputs: Tuple[torch.Tensor, ...] = ()  # the graph's own input buffers
        # the card's stream of the warm-ups and captures: a capture on a
        # stream that has run the work before maps and sets up less
        self.stream: Optional[torch.cuda.Stream] = None

    def load(self, key: tuple, inputs: Sequence[torch.Tensor]) -> None:
        """A step's start: under the same key the graph's buffers take this
        step's inputs; under another the graph is dropped."""
        if key != self.key:
            captured = self.replay is not None
            self.key, self.replay, self.inputs = key, None, ()
            if captured:
                # a dropped graph's pool goes back to the card only here:
                # the allocator never frees it inside the next capture
                torch.cuda.empty_cache()
        elif self.replay is not None:
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)

    def run(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor], rng: torch.Generator,
            key_fn: Callable[[], tuple], updates: Sequence[Tuple[TrainState, int]]
            ) -> Tuple[Any, bool]:
        """`fn(*inputs)` (tensors, or a tuple or dict of them), eager as the
        warm-up, else (captured first) the graph's replay; each (state, n) of
        `updates` counts the n Adam updates that `fn` makes of it. Returns
        (fn's outputs, whether the graph ran them)."""
        if self.stream is None and inputs[0].device.type == "cuda":
            self.stream = torch.cuda.Stream(inputs[0].device)
        if not self.warm or any(not s.optimizer.state for s, _ in updates):
            with _on(self.stream):
                out = fn(*inputs)
            self.key, self.warm = key_fn(), True  # Adam's state now exists
            return out, False
        steps = [s.step for s, _ in updates]  # the capture updates nothing, a replay runs no Python
        if self.replay is None:
            self.inputs = tuple(t.clone() for t in inputs)
            with _on(self.stream):
                self.replay = _capture(lambda: fn(*self.inputs), rng)
        with span(self.replay_span) if self.replay_span else contextlib.nullcontext():
            out = self.replay()
        for (state, n), step in zip(updates, steps):
            state.step = step + n
        return _cloned(out), True


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
    d_graph, step_graph = _KeyedGraph(), _KeyedGraph("gan.step_replay")

    def work(gen_state: TrainState, disc_state: TrainState, lstate: LambdaState,
             frames, regions, captions, lengths, epsilon: float, rng: torch.Generator,
             run_substep: Callable[[int, Callable[..., torch.Tensor], tuple], torch.Tensor]
             ) -> Tuple[LambdaState, Metrics]:
        """The step on the batch's device tensors, D's substep i run by
        `run_substep(i, d_substep, d_inputs)`: (lstate, metrics)."""
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
        d_inputs = (r_caption, f_caption, obj, mot, att_mask, alpha,
                    obj2, mot2, att2, alpha2, real_fake)

        def d_substep(r_caption, f_caption, obj, mot, att_mask, alpha,
                      obj2, mot2, att2, alpha2, real_fake, eps=None):
            """One WGAN-GP substep of D: [loss_d, r - f, gp]."""

            def d_fn(caps):
                return disc_model(caps, obj, mot, att_mask, alpha, rng=rng)

            # real | fake in one grouped pass, under cfg.disc_remat (the
            # penalty's pass at B is never rematerialized, as in JAX)
            d_grouped = remat(
                lambda caps, rng: disc_model(caps, obj2, mot2, att2, alpha2, groups=2, rng=rng),
                cfg.disc_remat, rng, module=disc_model,
            )
            if eps is None:
                eps = rank_block_rand((B, 1, 1), rng, dev)
            eps = eps.reshape(B, 1, 1).to(r_caption.dtype)
            scores = d_grouped(real_fake)
            r_loss, f_loss = batch_share(scores[:B]), batch_share(scores[B:])
            with span("gan.penalty"):
                gp = gradient_penalty(d_fn, r_caption, f_caption, eps)
            loss_d = f_loss - r_loss + GP_WEIGHT * gp
            disc_state.apply_gradients(_grads(loss_d, disc_state.params))
            return torch.stack([loss_d, r_loss - f_loss, gp]).detach()

        d_stats = []
        for i in range(num_d):
            with span("gan.d_substep", i):
                d_stats.append(run_substep(i, d_substep, d_inputs))

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
        count("gan.steps")
        for name in ("gan.steps_graphed", "gan.d_substeps_graphed"):
            count(name, 0)  # the shares read 0 where no graph runs

        with _training(gen_model, disc_model):
            if step_graph_engaged(dev, cfg, eps_gp):
                for state in (gen_state, disc_state):
                    if not state.capturable:
                        state.set_capturable(True)
                names = sorted(lstate)
                step_inputs = (*inputs, *(lstate[k] for k in names))

                def whole(frames, regions, captions, lengths, *lvalues):
                    # its substeps are counted around the graph
                    return work(gen_state, disc_state, dict(zip(names, lvalues)),
                                frames, regions, captions, lengths, epsilon, rng,
                                lambda i, d_substep, d_inputs: d_substep(*d_inputs))

                def key_fn():
                    return _step_graph_key(gen_state, disc_state, step_inputs, rng, num_d,
                                           epsilon, single_fwd)

                step_graph.load(key_fn(), step_inputs)
                (lstate, metrics), replayed = step_graph.run(
                    whole, step_inputs, rng, key_fn, ((gen_state, 1), (disc_state, num_d)))
                count("gan.d_substeps", num_d)
                if replayed:
                    count("gan.steps_graphed")
                    count("gan.d_substeps_graphed", num_d)

            elif d_graph_engaged(dev, cfg, eps_gp):
                if not disc_state.capturable:
                    disc_state.set_capturable(True)

                def graphed_substep(i, d_substep, d_inputs):
                    def key_fn():
                        return _d_graph_key(disc_state, d_inputs, rng, num_d)

                    if i == 0:
                        d_graph.load(key_fn(), d_inputs)
                    count("gan.d_substeps")
                    stats, replayed = d_graph.run(d_substep, d_inputs, rng, key_fn,
                                                  ((disc_state, 1),))
                    if replayed:
                        count("gan.d_substeps_graphed")
                    return stats

                lstate, metrics = work(gen_state, disc_state, lstate, *inputs, epsilon, rng,
                                       graphed_substep)

            else:
                def eager_substep(i, d_substep, d_inputs):
                    count("gan.d_substeps")
                    eps = (None if eps_gp is None else
                           torch.as_tensor(eps_gp[i], dtype=torch.float32, device=dev))
                    return d_substep(*d_inputs, eps=eps)

                lstate, metrics = work(gen_state, disc_state, lstate, *inputs, epsilon, rng,
                                       eager_substep)

        return gen_state, disc_state, lstate, metrics

    return step
