"""D's WGAN-GP substep replayed from a CUDA graph (train/steps.py).

On the CPU: the rule that decides where the graph engages, the key that
says when it is captured again, the step's generator (one object re-seeded
each step draws what a fresh one would), the counters that
`d_graph_share.train` reads, and the graphed flow itself with the capture
replaced by a function that runs the substep again (warm-up, capture,
replays, captures again after a change of learning rate) against the eager
loop, bitwise.

On the card (marker `cuda`; skipped without one; no JAX, so run without the
suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gan_graph.py

graphed GAN steps against eager ones with the same capturable Adam, bitwise,
at tiny widths and at the benchmark's MSR-VTT widths over three steps with
a change of learning rate; the generator's draws inside and around a graph;
a checkpoint of D's capturable Adam state, then a graphed step; and the
benchmark's planted D faults, caught with the graph engaged.
"""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dlsg_tpu_torch import checkpoint as ckpt
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import losses
from dlsg_tpu_torch.train import optim, steps
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.steps import (
    StepRng,
    _d_graph_key,
    d_graph_engaged,
    make_gan_train_step,
    step_generator,
)
from dlsg_tpu_torch.utils import profiler
from portbench import control, harness
from portbench.tests.tiny import tiny_run

V = 40
KEY = 3_900_001_801  # beyond 32 signed bits, as the benchmark's seeds are


@pytest.fixture(autouse=True)
def fresh_tables():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, n, vocab, seed=21):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, cfg.max_words + 1, size=n).astype(np.int32)
    caps = np.where(np.arange(cfg.max_words)[None] < lengths[:, None],
                    rng.integers(4, vocab, size=(n, cfg.max_words)), 0).astype(np.int32)
    return {
        "frames": rng.normal(size=(n, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(
            size=(n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32),
        "captions": caps,
        "lengths": lengths,
    }


class _World:
    """A generator and a discriminator with fixed initial weights; `states`
    gives fresh Adam states on those weights."""

    def __init__(self, cfg, vocab, device):
        self.cfg, self.vocab, self.device = cfg, vocab, device
        self.gen = CapGnnModel(cfg, vocab, device=device)
        self.disc = DiscV2(cfg, vocab, device=device)
        self.init = [{k: v.clone() for k, v in m.state_dict().items()} for m in (self.gen, self.disc)]

    def states(self, lr=1e-3):
        for m, sd in zip((self.gen, self.disc), self.init):
            m.load_state_dict(sd)
        return (TrainState.create(self.gen, make_optimizer(lr, self.cfg.grad_clip)),
                TrainState.create(self.disc, make_optimizer(lr)),
                init_lambda_state(0.01, device=self.device))


def _run_steps(world, batches, lr_change_before=2, capturable=False):
    """len(batches) GAN steps from the initial weights, the learning rates
    halved before step `lr_change_before` (0-based): the metrics of each,
    then every parameter and Adam moment, and the step counters."""
    gs, ds, lam = world.states()
    if capturable:
        ds.set_capturable(True)
    fn = make_gan_train_step(world.gen, world.disc, world.cfg)
    metrics = []
    for i, b in enumerate(batches):
        if i == lr_change_before:
            gs.set_learning_rate(gs.optimizer.param_groups[0]["lr"] / 2)
            ds.set_learning_rate(ds.optimizer.param_groups[0]["lr"] / 2)
        gs, ds, lam, m = fn(gs, ds, lam, b, KEY, 0.9)
        metrics.append({k: v.detach().clone() for k, v in m.items()})
    tensors = {}
    for tag, st in (("G", gs), ("D", ds)):
        tensors.update({f"{tag}.{k}": v.detach().clone() for k, v in st.module.state_dict().items()})
        for n, p in zip(st.names, st.params):
            for slot in ("exp_avg", "exp_avg_sq"):
                tensors[f"{tag}.{slot}.{n}"] = st.optimizer.state[p][slot].clone()
    return metrics, tensors, (gs.step, ds.step)


def _assert_bitwise(got, want):
    gm, gt, gsteps = got
    wm, wt, wsteps = want
    assert gsteps == wsteps
    for i, (a, b) in enumerate(zip(gm, wm)):
        for k in b:
            assert torch.equal(a[k], b[k]), (i, k, a[k], b[k])
    bad = {k: float((gt[k].double() - v.double()).abs().max()) for k, v in wt.items()
           if not torch.equal(gt[k], v)}
    assert not bad, f"{len(bad)} of {len(wt)} tensors differ, max |diff|: {bad}"


def _counting_captures(monkeypatch, fake=False):
    """Wrap `steps._capture` to count captures; with `fake`, the capture
    is a function that runs the substep again at each "replay" (the CPU's
    stand-in: a capture runs nothing, each replay does the work)."""
    made = []
    real = steps._capture

    def capture(fn, rng):
        made.append(rng)
        return fn if fake else real(fn, rng)

    monkeypatch.setattr(steps, "_capture", capture)
    return made


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("device,fields,eps_gp,data_axis,engaged", [
    ("cpu", {}, None, False, False),
    ("cuda", {}, None, True, False),
    ("cuda", {}, torch.zeros(5, 4), False, False),
    ("cuda", {"disc_remat": "dots"}, None, False, False),
    ("cuda", {"disc_remat": "full"}, None, False, False),
    ("cuda", {}, None, False, True),
], ids=["cpu", "data-axis", "eps_gp", "remat-dots", "remat-full", "card"])
def test_where_the_graph_engages(monkeypatch, device, fields, eps_gp, data_axis, engaged):
    """Only on a card, with no data axis, the step's own penalty draws and no
    remat of D's pass; everything else runs the eager loop."""
    monkeypatch.setattr(steps, "data_axis_active", lambda: data_axis)
    cfg = replace(tiny_test_config(), **fields)
    assert d_graph_engaged(torch.device(device), cfg, eps_gp) is engaged


def test_the_graph_key_follows_what_the_graph_bakes_in(monkeypatch):
    """A learning rate, a batch shape, a clamp or a function planted in the
    step changes the key; another batch of the same shape keeps it."""
    cfg = tiny_test_config()
    disc = DiscV2(cfg, V, device="cpu")
    state = TrainState.create(disc, make_optimizer(1e-3))
    rng = StepRng()(KEY, 0, "cpu")

    def inputs(n, fill):
        return (torch.full((n, cfg.max_words, V), fill), torch.full((n, cfg.max_words, 8), fill))

    key = _d_graph_key(state, inputs(4, 0.0), rng, 5)
    assert _d_graph_key(state, inputs(4, 1.0), rng, 5) == key
    assert _d_graph_key(state, inputs(8, 0.0), rng, 5) != key
    assert _d_graph_key(state, inputs(4, 0.0), rng, 4) != key
    state.set_learning_rate(5e-4)
    assert _d_graph_key(state, inputs(4, 0.0), rng, 5) != key
    state.set_learning_rate(1e-3)
    assert _d_graph_key(state, inputs(4, 0.0), rng, 5) == key
    clamped = TrainState(state.module, state.optimizer, replace(state.config, grad_clip=1.0),
                         state.names, state.params)
    assert _d_graph_key(clamped, inputs(4, 0.0), rng, 5) != key
    monkeypatch.setattr(steps, "batch_share", lambda x: x.sum())
    assert _d_graph_key(state, inputs(4, 0.0), rng, 5) != key


def test_one_generator_reseeded_each_step_draws_what_a_fresh_one_does():
    """Across two steps and draws of several sizes (dropout masks, the
    penalty's mixing weights): bitwise, and the same object each step."""
    step_rng = StepRng()
    seen = []
    for step in (0, 1):
        gen = step_rng(KEY, step, "cpu")
        fresh = step_generator(KEY, step, "cpu")
        for shape in ((4, 1, 1), (3, 7, 16), (1,)):
            assert torch.equal(torch.rand(shape, generator=gen), torch.rand(shape, generator=fresh))
        seen.append(gen)
    assert seen[0] is seen[1]


def test_the_counters_on_the_cpu_and_d_graph_share_reads_zero():
    """Under a trace every substep counts in `gan.d_substeps` and none in
    `gan.d_substeps_graphed`: the benchmark's `d_graph_share.train` reads 0."""
    cfg = tiny_test_config(num_D_visual=3)
    world = _World(cfg, V, "cpu")
    gs, ds, lam = world.states()
    fn = make_gan_train_step(world.gen, world.disc, cfg)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        for _ in range(2):
            gs, ds, lam, _ = fn(gs, ds, lam, _batch(cfg, 4, V), KEY, 0.9)
    finally:
        prof.stop()
    c = profiler.counters()
    assert c["gan.d_substeps"] == 2 * cfg.num_D_visual
    assert c["gan.d_substeps_graphed"] == 0
    entry = harness.load_json("metrics", "d_graph_share.train.json")
    reader = harness.load_module("readers", entry["reader"])
    assert reader.read({}, **entry["args"]) == 0.0


def test_a_graphed_adam_checkpoint_resumes_on_the_cpu(tmp_path):
    """D's Adam state saved capturable (as on a card whose GAN step replays
    D's substeps) and resumed on the CPU, where Adam cannot be capturable:
    plain again, its step counts on the host, and a GAN step runs."""
    cfg = tiny_test_config(num_D_visual=2)
    world = _World(cfg, V, "cpu")
    gs, ds, lam = world.states()
    fn = make_gan_train_step(world.gen, world.disc, cfg)
    gs, ds, lam, _ = fn(gs, ds, lam, _batch(cfg, 4, V), KEY, 0.9)
    path = ckpt.save_train(str(tmp_path), 1, gs, ds, lam)
    payload = torch.load(path, weights_only=True)
    for group in payload["disc_opt"]["param_groups"]:
        group["capturable"] = True
    torch.save(payload, path)

    gs2, ds2, lam2 = world.states()
    out = ckpt.restore_train(str(tmp_path), 1, gs2, ds2, lam2)
    ds2 = out["disc_state"]
    assert not ds2.capturable and ds2.step == ds.step == cfg.num_D_visual
    assert {ds2.optimizer.state[p]["step"].device.type for p in ds2.params} == {"cpu"}
    _, ds2, _, m = fn(out["gen_state"], ds2, out["gan_lambda_state"], _batch(cfg, 4, V), KEY, 0.9)
    assert ds2.step == 2 * cfg.num_D_visual and torch.isfinite(m["loss_D"])


@pytest.mark.parametrize("graphed,total,share", [(None, None, None), (0, 5, 0.0), (2, 5, 40.0),
                                                 (5, 5, 100.0)])
def test_d_graph_share_is_the_benchmark_entry_over_the_two_counters(graphed, total, share):
    """`d_graph_share.train` as the benchmark declares it: the program
    counter reader over `gan.d_substeps_graphed` / `gan.d_substeps`, in the
    GAN cell; silent where nothing was counted (as in a program without the
    counters)."""
    (entry,) = [m for m in harness.benchmark()["per_layer"] if m["name"] == "d_graph_share.train"]
    assert entry == {"name": "d_graph_share.train", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "train step (train/steps.py, models/)",
                     "moves": "train_clips_per_s", "workloads": ["msrvtt-gan-b128"]}
    spec = harness.load_json("metrics", "d_graph_share.train.json")
    assert spec == {"reader": "program_counter",
                    "args": {"num": "gan.d_substeps_graphed", "den": "gan.d_substeps"}}
    if total is not None:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        profiler.count("gan.d_substeps", total)
        profiler.count("gan.d_substeps_graphed", graphed)
        prof.stop()
    value = harness.load_module("readers", spec["reader"]).read({}, **spec["args"])
    assert value == (None if share is None else pytest.approx(share))


def test_the_graphed_flow_equals_the_eager_loop_on_the_cpu(monkeypatch):
    """The graphed flow with the capture replaced by the substep run again
    at each replay: three steps, the learning rates halved before the third,
    equal the eager loop bitwise; a capture in the first step (after the
    eager warm-up) and again after the change, and every other substep
    counted as a replay."""
    cfg = tiny_test_config(num_D_visual=3)
    world = _World(cfg, V, "cpu")
    batches = [_batch(cfg, 4, V, seed=s) for s in (1, 2, 3)]
    want = _run_steps(world, batches)

    monkeypatch.setattr(steps, "d_graph_engaged", lambda dev, cfg, eps_gp: eps_gp is None)
    monkeypatch.setattr(optim.TrainState, "set_capturable", lambda self, on: self)
    made = _counting_captures(monkeypatch, fake=True)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        got = _run_steps(world, batches)
    finally:
        prof.stop()
    _assert_bitwise(got, want)
    assert len(made) == 2
    c = profiler.counters()
    assert c["gan.d_substeps"] == 9
    assert c["gan.d_substeps_graphed"] == 9 - 2  # the two warm-up substeps ran eager


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_the_step_generator_inside_and_around_a_graph_on_card(card):
    """Draws before, inside (two replays) and after a captured graph that
    follows the step's generator, over two steps, equal a fresh generator's
    eager draws bitwise: each replay advances the generator by what its
    draws would eagerly."""

    def before(gen):
        return [torch.rand((128, 1, 1), generator=gen, device=card)]

    def inside(gen):
        return [torch.rand((256, 26, 512), generator=gen, device=card),
                torch.rand((128, 1, 1), generator=gen, device=card)]

    def after(gen):
        return [torch.rand((7, 333), generator=gen, device=card)]

    step_rng = StepRng()
    gen = step_rng(KEY, 0, card)
    out = {}
    replay = steps._capture(lambda: out.update(t=inside(gen)), gen)
    for step in (0, 1):
        fresh = step_generator(KEY, step, card)
        want = before(fresh) + inside(fresh) + inside(fresh) + after(fresh)
        assert step_rng(KEY, step, card) is gen
        got = before(gen)
        for _ in range(2):
            replay()
            got += [t.clone() for t in out["t"]]
        got += after(gen)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["tiny", "msrvtt"])
def test_graphed_gan_steps_equal_eager_on_card(card, widths, monkeypatch):
    """Three GAN steps, the learning rates halved before the third: the
    graphed substeps against the eager loop with the same capturable Adam,
    bitwise (metrics, parameters, both Adam moments, step counters), with a
    capture in the first step and again after the change."""
    if widths == "tiny":
        cfg, vocab, n = tiny_test_config(), 50, 4
    else:
        spec = harness.benchmark()
        run = harness.Run(SimpleNamespace(seed=KEY, seconds=0, trace=0), spec,
                          harness.cell_of(spec, "msrvtt-gan-b128"), 0.0, device=card)
        cfg, vocab, n = run.program_config("training"), run.config["vocab_size"], 16
    world = _World(cfg, vocab, card)
    batches = [_batch(cfg, n, vocab, seed=s) for s in (1, 2, 3)]
    made = _counting_captures(monkeypatch)
    got = _run_steps(world, batches)
    assert len(made) == 2
    with monkeypatch.context() as m:
        m.setattr(steps, "d_graph_engaged", lambda dev, cfg, eps_gp: False)
        want = _run_steps(world, batches, capturable=True)
    assert len(made) == 2
    _assert_bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("capturable_before", [False, True])
def test_a_checkpoint_of_capturable_adam_then_a_graphed_step_on_card(
        card, tmp_path, capturable_before):
    """Two graphed steps, a checkpoint, a third step; against fresh states
    (plain or already capturable) restored from the checkpoint, which makes
    D's Adam capturable with its step counts on the card, as saved, then the
    third step by a new step function: bitwise."""
    cfg = tiny_test_config()
    world = _World(cfg, 50, card)
    batches = [_batch(cfg, 4, 50, seed=s) for s in (1, 2, 3)]
    gs, ds, lam = world.states()
    fn = make_gan_train_step(world.gen, world.disc, cfg)
    for b in batches[:2]:
        gs, ds, lam, _ = fn(gs, ds, lam, b, KEY, 0.9)
    assert ds.capturable
    ckpt.save_train(str(tmp_path), 1, gs, ds, lam)
    gs, ds, lam, want = fn(gs, ds, lam, batches[2], KEY, 0.9)
    want_t = {k: v.clone() for k, v in {**world.gen.state_dict(), **world.disc.state_dict()}.items()}

    gs2, ds2, lam2 = world.states()
    ds2.set_capturable(capturable_before)
    out = ckpt.restore_train(str(tmp_path), 1, gs2, ds2, lam2)
    gs2, ds2, lam2 = out["gen_state"], out["disc_state"], out["gan_lambda_state"]
    assert ds2.capturable and not gs2.capturable
    assert {ds2.optimizer.state[p]["step"].device.type for p in ds2.params} == {"cuda"}
    gs2, ds2, lam2, got = make_gan_train_step(world.gen, world.disc, cfg)(
        gs2, ds2, lam2, batches[2], KEY, 0.9)
    assert ds2.step == ds.step and gs2.step == gs.step
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in {**world.gen.state_dict(), **world.disc.state_dict()}.items():
        assert torch.equal(v, want_t[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["", *sorted(control.FAULTS)])
def test_planted_d_faults_are_caught_with_the_graph_on_card(card, monkeypatch, fault):
    """The benchmark's training run at tiny widths on the card, with the
    graph engaged: sound, it is correct; with D's Wasserstein term over half
    its batch or without its penalty (planted by name in train/steps.py, so
    in the captured substep too), G's first step is untouched and D's
    numbers fail."""
    made = _counting_captures(monkeypatch)
    r = tiny_run("msrvtt-gan-b128", seed=4_100_001_805)
    r.device = card
    with control.planted(fault):
        out = harness.load_module("drivers", "train_step").run(r)
    assert made
    checks = {c.name: c for c in out.checks}
    correct = harness.result_line(r, out, {})[0]["correct"]
    if fault:
        assert checks["loss_gap"].ok() and not checks["d_loss_gap"].ok(), out.checks
        assert correct is False
    else:
        assert correct is True, out.checks


def test_the_penalty_is_planted_by_name():
    """What the fault test rests on: the step reaches the penalty and the
    batch share through train/steps.py's own names."""
    assert steps.gradient_penalty is losses.gradient_penalty
    assert steps.batch_share is losses.batch_share
