"""The GAN step replayed from one CUDA graph (train/steps.py, through
utils/cuda_graph.py), under every remat policy.

On the CPU: the rule that decides where the graph engages, the key that
says when the graph is captured again, the step's generator (one object
re-seeded each step draws what a fresh one would), the counters that
`step_graph_share.train` and `d_graph_share.train` read, the graphed flow
itself with the capture replaced by a function that runs the graphed part
again into the same output tensors (warm-up and capture, replays, both
again after a change of learning rate) against the eager loop, bitwise; a
new key gives the dropped graph's pool back; a step's metrics and lambda
state outlive the next replay; and a graph's forks, with the card's parts
stubbed.

On the card (marker `cuda`; skipped without one; no JAX, so run without the
suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gan_graph.py

graphed GAN steps against eager ones with the same capturable Adam,
bitwise, at tiny widths and at the benchmark's MSR-VTT widths over four
steps with a change of learning rate, without remat and under
`decoder_remat` and `disc_remat`; the generator's draws inside and around a
graph; re-keyed graphs giving their pools back; a checkpoint of both
capturable Adam states, then a graphed step; and the benchmark's planted D
faults, caught with the step graph engaged.
"""

import contextlib
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
    _step_graph_key,
    make_gan_train_step,
    step_generator,
    step_graph_engaged,
)
from dlsg_tpu_torch.utils import cuda_graph, profiler
from portbench import control, harness
from portbench.tests.tiny import tiny_run

V = 40
KEY = 3_900_001_801  # beyond 32 signed bits, as the benchmark's seeds are


@pytest.fixture(autouse=True)
def fresh_tables():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread per test, as the suite's other model tests
    take (tests/test_torch_train_steps.py, which this file cannot import:
    it imports JAX, and the card runs this file without it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _run_steps(world, batches, lr_change_before=2, capturable=()):
    """len(batches) GAN steps from the initial weights, the learning rates
    halved before step `lr_change_before` (0-based), the Adam of the states
    named in `capturable` ("G", "D") made capturable first: the metrics of
    each, then every parameter and Adam moment, and the step counters."""
    gs, ds, lam = world.states()
    for tag, st in (("G", gs), ("D", ds)):
        if tag in capturable:
            st.set_capturable(True)
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


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for k in (dst if isinstance(dst, dict) else range(len(dst))):
            _copy_into(dst[k], src[k])


def _counting_captures(monkeypatch, fake=False):
    """Wrap `cuda_graph.Graph.capture` to count captures; with `fake`, the
    capture makes the graph's replay a function that runs the graphed part
    again and writes its outputs into the first replay's tensors (the CPU's
    stand-in: a capture runs nothing, each replay does the work into the
    graph's own memory)."""
    made = []
    real = cuda_graph.Graph.capture

    def capture(self, fn):
        made.append(len(made))  # not the graph: a list that held it would keep its pool
        if not fake:
            return real(self, fn)
        held = []

        def replay():
            out = fn()
            if held:
                _copy_into(held[0], out)
            else:
                held.append(out)
            return held[0]

        self.replay = replay

    monkeypatch.setattr(cuda_graph.Graph, "capture", capture)
    return made


def _graphed_on_the_cpu(monkeypatch):
    """The graphed flow engaged on the CPU, Adam left plain (the CPU's
    cannot be capturable); returns the fake captures made."""
    monkeypatch.setattr(steps, "step_graph_engaged", lambda dev, cfg, eps_gp: eps_gp is None)
    monkeypatch.setattr(optim.TrainState, "set_capturable", lambda self, on: self)
    return _counting_captures(monkeypatch, fake=True)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("device,fields,eps_gp,data_axis,engaged", [
    ("cpu", {}, None, False, "eager"),
    ("cuda", {}, None, True, "eager"),
    ("cuda", {}, torch.zeros(5, 4), False, "eager"),
    ("cuda", {"disc_remat": "dots"}, None, False, "step"),
    ("cuda", {"disc_remat": "full"}, None, False, "step"),
    ("cuda", {}, None, False, "step"),
    ("cuda", {"decoder_remat": "dots"}, None, False, "step"),
    ("cuda", {"decoder_remat": "full"}, None, False, "step"),
    ("cuda", {"decoder_remat": "full", "disc_remat": "dots"}, None, False, "step"),
    ("cpu", {"decoder_remat": "dots"}, None, False, "eager"),
], ids=["cpu", "data-axis", "eps_gp", "remat-dots", "remat-full", "card", "decoder-remat-dots",
        "decoder-remat-full", "both-remats", "cpu-decoder-remat"])
def test_where_the_graph_engages(monkeypatch, device, fields, eps_gp, data_axis, engaged):
    """The whole step's graph on a card, with no data axis and the step's
    own penalty draws, under every remat policy; everything else runs the
    eager loop."""
    monkeypatch.setattr(steps, "data_axis_active", lambda: data_axis)
    cfg = replace(tiny_test_config(), **fields)
    assert step_graph_engaged(torch.device(device), cfg, eps_gp) is (engaged == "step")


@pytest.mark.parametrize("change", ["epsilon", "g_lr", "d_lr", "g_clamp", "d_clamp",
                                    "single_forward", "num_d", "lambda_window", "batch",
                                    "g_adam_state", "planted_g_loss", "planted_d_share"])
def test_the_step_graph_key_follows_what_the_step_bakes_in(monkeypatch, change):
    """Each thing that the whole step's graph bakes in changes its key: the
    teacher-forcing ratio, either learning rate, either clamp, the
    forward's sharing, the substep count, the lambda state's shape, the
    batch's shape, G's Adam tensors, a function planted in the step (G's
    loss, or D's batch share, as the benchmark plants its D faults).
    Another batch and lambda state of the same shapes keep it."""
    cfg = tiny_test_config()
    gs = TrainState.create(CapGnnModel(cfg, V, device="cpu"), make_optimizer(1e-3, cfg.grad_clip))
    ds = TrainState.create(DiscV2(cfg, V, device="cpu"), make_optimizer(1e-3))
    rng = StepRng()(KEY, 0, "cpu")

    def key(gs=gs, ds=ds, n=4, fill=0, window=200, epsilon=0.9, single=True, num_d=5):
        lam = init_lambda_state(0.01 + fill, window=window, device="cpu")
        inputs = (torch.full((n, cfg.max_frames, cfg.feature_size), float(fill)),
                  torch.full((n, cfg.max_words), fill, dtype=torch.int64), *lam.values())
        return _step_graph_key(gs, ds, inputs, rng, num_d, epsilon, single)

    def clamped(st):
        return TrainState(st.module, st.optimizer, replace(st.config, grad_clip=1.0),
                          st.names, st.params)

    base = key()
    assert key(fill=1) == base
    changed = {
        "epsilon": lambda: key(epsilon=0.8),
        "g_lr": lambda: key(gs=gs.set_learning_rate(5e-4)),
        "d_lr": lambda: (ds.set_learning_rate(5e-4), key())[1],
        "g_clamp": lambda: key(gs=clamped(gs)),
        "d_clamp": lambda: key(ds=clamped(ds)),
        "single_forward": lambda: key(single=False),
        "num_d": lambda: key(num_d=4),
        "lambda_window": lambda: key(window=100),
        "batch": lambda: key(n=8),
        "g_adam_state": lambda: key(gs=gs.apply_gradients([torch.zeros_like(p) for p in gs.params])),
        "planted_g_loss": lambda: (monkeypatch.setattr(steps, "wgan_g_loss", lambda x: x.sum()),
                                   key())[1],
        "planted_d_share": lambda: (monkeypatch.setattr(steps, "batch_share", lambda x: x.sum()),
                                    key())[1],
    }[change]()
    assert changed != base


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
    """Under a trace every step counts in `gan.steps` and every substep in
    `gan.d_substeps`, none in `gan.steps_graphed` or
    `gan.d_substeps_graphed`: the benchmark's `d_graph_share.train` and
    `step_graph_share.train` read 0."""
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
    assert c["gan.steps"] == 2 and c["gan.steps_graphed"] == 0
    assert c["gan.d_substeps"] == 2 * cfg.num_D_visual
    assert c["gan.d_substeps_graphed"] == 0
    for name in ("d_graph_share.train.json", "step_graph_share.train.json"):
        entry = harness.load_json("metrics", name)
        reader = harness.load_module("readers", entry["reader"])
        assert reader.read({}, **entry["args"]) == 0.0


def test_a_graphed_adam_checkpoint_resumes_on_the_cpu(tmp_path):
    """Both Adam states saved capturable (as on a card whose GAN step
    replays from a graph) and resumed on the CPU, where Adam cannot be
    capturable: plain again, their step counts on the host, and a GAN step
    runs."""
    cfg = tiny_test_config(num_D_visual=2)
    world = _World(cfg, V, "cpu")
    gs, ds, lam = world.states()
    fn = make_gan_train_step(world.gen, world.disc, cfg)
    gs, ds, lam, _ = fn(gs, ds, lam, _batch(cfg, 4, V), KEY, 0.9)
    path = ckpt.save_train(str(tmp_path), 1, gs, ds, lam)
    payload = torch.load(path, weights_only=True)
    for opt in ("gen_opt", "disc_opt"):
        for group in payload[opt]["param_groups"]:
            group["capturable"] = True
    torch.save(payload, path)

    gs2, ds2, lam2 = world.states()
    out = ckpt.restore_train(str(tmp_path), 1, gs2, ds2, lam2)
    gs2, ds2 = out["gen_state"], out["disc_state"]
    assert not gs2.capturable and gs2.step == gs.step == 1
    assert not ds2.capturable and ds2.step == ds.step == cfg.num_D_visual
    for st in (gs2, ds2):
        assert {st.optimizer.state[p]["step"].device.type for p in st.params} == {"cpu"}
    gs2, ds2, _, m = fn(gs2, ds2, out["gan_lambda_state"], _batch(cfg, 4, V), KEY, 0.9)
    assert gs2.step == 2 and ds2.step == 2 * cfg.num_D_visual and torch.isfinite(m["loss_D"])


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


@pytest.mark.parametrize("graphed,total,share", [(None, None, None), (0, 5, 0.0), (3, 5, 60.0),
                                                 (5, 5, 100.0)])
def test_step_graph_share_is_the_benchmark_entry_over_the_two_counters(graphed, total, share):
    """`step_graph_share.train` as the benchmark declares it: the program
    counter reader over `gan.steps_graphed` / `gan.steps`, in the GAN cell;
    silent where nothing was counted (as in a program without the
    counters)."""
    (entry,) = [m for m in harness.benchmark()["per_layer"] if m["name"] == "step_graph_share.train"]
    assert entry == {"name": "step_graph_share.train", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "train step (train/steps.py, models/)",
                     "moves": "train_clips_per_s", "workloads": ["msrvtt-gan-b128"]}
    spec = harness.load_json("metrics", "step_graph_share.train.json")
    assert spec == {"reader": "program_counter",
                    "args": {"num": "gan.steps_graphed", "den": "gan.steps"}}
    if total is not None:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        profiler.count("gan.steps", total)
        profiler.count("gan.steps_graphed", graphed)
        prof.stop()
    value = harness.load_module("readers", spec["reader"]).read({}, **spec["args"])
    assert value == (None if share is None else pytest.approx(share))


@pytest.mark.parametrize("fields", [
    {}, {"gan_single_forward": False}, {"decoder_remat": "dots"}, {"disc_remat": "full"},
], ids=["step", "step-two-forwards", "step-decoder-remat-dots", "step-disc-remat-full"])
def test_the_graphed_flow_equals_the_eager_loop_on_the_cpu(monkeypatch, fields):
    """The graphed flow with the capture replaced by the graphed part run
    again at each replay: four steps, the learning rates halved before the
    third, equal the eager loop bitwise, without remat and under either.
    The first and the third step (a new key) run eager and capture; the
    second and the fourth replay, each counting one graphed step and
    `num_D_visual` graphed substeps."""
    cfg = replace(tiny_test_config(num_D_visual=3), **fields)
    world = _World(cfg, V, "cpu")
    batches = [_batch(cfg, 4, V, seed=s) for s in (1, 2, 3, 4)]
    want = _run_steps(world, batches)

    made = _graphed_on_the_cpu(monkeypatch)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        got = _run_steps(world, batches)
    finally:
        prof.stop()
    _assert_bitwise(got, want)
    assert len(made) == 2
    c = profiler.counters()
    assert (c["gan.steps"], c["gan.steps_graphed"]) == (4, 2)
    assert (c["gan.d_substeps"], c["gan.d_substeps_graphed"]) == (12, 6)


@pytest.mark.parametrize("fields", [{}, {"decoder_remat": "full"}], ids=["step", "decoder-remat"])
def test_a_new_key_gives_the_dropped_graphs_pool_back(monkeypatch, fields):
    """The allocator frees a dropped graph's pool only when asked, and never
    inside the next capture: a new key after a capture asks once, before
    the capture that follows; the first capture, with nothing to drop,
    does not ask."""
    cfg = tiny_test_config(num_D_visual=2, **fields)
    world = _World(cfg, V, "cpu")
    made = _graphed_on_the_cpu(monkeypatch)
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(len(made)))
    _run_steps(world, [_batch(cfg, 4, V, seed=s) for s in (1, 2, 3)])
    assert len(made) == 2 and emptied == [1]


def test_a_steps_metrics_and_lambda_state_outlive_the_next_replay(monkeypatch):
    """The benchmark and the trainer read a step's cap_loss after the next
    step was launched: what a replayed step hands back (its metrics and
    lambda state) stays its own while later replays write the graph's
    outputs again."""
    cfg = tiny_test_config(num_D_visual=2)
    world = _World(cfg, V, "cpu")
    made = _graphed_on_the_cpu(monkeypatch)
    gs, ds, lam = world.states()
    fn = make_gan_train_step(world.gen, world.disc, cfg)
    handed, kept = [], []
    for s in (1, 2, 3, 4):
        gs, ds, lam, m = fn(gs, ds, lam, _batch(cfg, 4, V, seed=s), KEY, 0.9)
        handed.append((m, lam))
        kept.append([{k: v.clone() for k, v in d.items()} for d in (m, lam)])
    assert len(made) == 1
    for i, (now, then) in enumerate(zip(handed, kept)):
        for d, d0 in zip(now, then):
            for k, v in d0.items():
                assert torch.equal(d[k], v), (i, k)
    # the replays' outputs differ, so a shared tensor would have shown
    assert kept[2][1]["count"] != kept[3][1]["count"]
    assert not torch.equal(kept[2][0]["cap_loss"], kept[3][0]["cap_loss"])


class _HostGen:
    """The host side of a card generator as utils/cuda_graph.py reads and
    sets it: a seed and an offset, which a draw of n moves on by n."""

    def __init__(self, seed=0, offset=0):
        self.seed, self.offset = seed, offset

    def draw(self, n):
        at = (self.seed, self.offset)
        self.offset += n
        return at

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        self.offset = offset

    def initial_seed(self):
        return self.seed

    def manual_seed(self, seed):
        self.seed, self.offset = seed, 0
        return self

    def clone_state(self):
        return _HostGen(self.seed, self.offset)


class _StubGraph:
    """torch.cuda.CUDAGraph without a card: what was registered, captured
    in which mode, and how often it replayed."""

    def __init__(self):
        self.registered, self.modes, self.replays = [], [], 0

    def register_generator_state(self, gen):
        self.registered.append(gen)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.modes.append(capture_error_mode)

    def capture_end(self):
        pass

    def pool(self):
        return "the pool"

    def replay(self):
        self.replays += 1


def test_a_graphs_forks_follow_its_generator_with_the_card_stubbed(monkeypatch):
    """utils/cuda_graph.py's fork bookkeeping: the warm-up's forks stand
    where the generator stood and are noted with how far it had drawn
    since the warm-up began; the capture registers the generator and the
    forks and hands the same forks out in the same order; before each
    replay every fork is set to the generator's seed and position plus that
    distance. A capture that forks otherwise than its warm-up, and a fork of
    a generator the graph does not follow, raise; outside a graph a fork is
    a clone."""
    monkeypatch.setattr(cuda_graph, "_on", lambda stream: contextlib.nullcontext())
    monkeypatch.setitem(cuda_graph._streams, torch.device("cuda"), "the card's side stream")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    gen = _HostGen(seed=5, offset=100)
    handed, draws = [], []

    def region(extra_fork=False):
        gen.draw(4)
        first = cuda_graph.fork(gen)
        draws.append((gen.draw(8), first.draw(8)))  # the forward's masks, the recompute's
        second = cuda_graph.fork(gen)
        handed.append((first, second))
        if extra_fork:
            cuda_graph.fork(gen)
        return "outputs"

    graph = cuda_graph.Graph("cuda", gen)
    assert graph.warm_up(region) == "outputs"
    assert draws == [((5, 104), (5, 104))]
    assert graph.forks == list(zip(handed[0], (4, 12)))
    gen.manual_seed(6)
    graph.capture(region)
    assert graph.graph.registered == [gen, *handed[0]]
    assert graph.graph.modes == ["thread_local"] and graph.pool == "the pool"
    assert handed[1][0] is handed[0][0] and handed[1][1] is handed[0][1]
    for seed, offset in ((7, 0), (8, 40)):
        gen.manual_seed(seed).set_offset(offset)
        assert graph.replay() == "outputs"
        assert [(f.seed, f.offset) for f in handed[0]] == [(seed, offset + 4), (seed, offset + 12)]
    assert graph.graph.replays == 2

    with pytest.raises(RuntimeError, match="forks otherwise"):
        graph.capture(lambda: region(extra_fork=True))
    with pytest.raises(RuntimeError, match="forks otherwise"):
        graph.capture(lambda: None)
    with pytest.raises(ValueError, match="does not follow"):
        cuda_graph.Graph("cuda").warm_up(region)
    outside = cuda_graph.fork(gen)
    assert outside not in handed[0] and (outside.seed, outside.offset) == (gen.seed, gen.offset)


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
    graph = cuda_graph.Graph(card, gen)
    graph.capture(lambda: out.update(t=inside(gen)))
    for step in (0, 1):
        fresh = step_generator(KEY, step, card)
        want = before(fresh) + inside(fresh) + inside(fresh) + after(fresh)
        assert step_rng(KEY, step, card) is gen
        got = before(gen)
        for _ in range(2):
            graph.replay()
            got += [t.clone() for t in out["t"]]
        got += after(gen)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,fields", [
    ("tiny", {}), ("tiny", {"gan_single_forward": False}), ("msrvtt", {}),
    ("tiny", {"decoder_remat": "full"}), ("msrvtt", {"decoder_remat": "dots"}),
    ("tiny", {"disc_remat": "dots"}), ("tiny", {"decoder_remat": "full", "disc_remat": "full"}),
], ids=["tiny-step", "tiny-step-two-forwards", "msrvtt-step", "tiny-decoder-remat-full",
        "msrvtt-decoder-remat-dots", "tiny-disc-remat-dots", "tiny-both-remats"])
def test_graphed_gan_steps_equal_eager_on_card(card, widths, fields, monkeypatch):
    """Four GAN steps, the learning rates halved before the third: the
    whole step's graph against the eager loop with the same capturable
    Adam, bitwise (metrics, parameters, both Adam moments, step counters),
    without remat and under either (each recompute drawing its forward's
    masks from a fork that the replay set), with a capture in the first
    step and again after the change, each then replayed."""
    if widths == "tiny":
        cfg, vocab, n = tiny_test_config(), 50, 4
    else:
        spec = harness.benchmark()
        run = harness.Run(SimpleNamespace(seed=KEY, seconds=0, trace=0), spec,
                          harness.cell_of(spec, "msrvtt-gan-b128"), 0.0, device=card)
        cfg, vocab, n = run.program_config("training"), run.config["vocab_size"], 16
    cfg = replace(cfg, **fields)
    world = _World(cfg, vocab, card)
    batches = [_batch(cfg, n, vocab, seed=s) for s in (1, 2, 3, 4)]
    made = _counting_captures(monkeypatch)
    got = _run_steps(world, batches)
    assert len(made) == 2
    with monkeypatch.context() as m:
        m.setattr(steps, "step_graph_engaged", lambda dev, cfg, eps_gp: False)
        want = _run_steps(world, batches, capturable=("G", "D"))
    assert len(made) == 2
    _assert_bitwise(got, want)


@pytest.mark.cuda
def test_re_keyed_step_graphs_give_their_pools_back_on_card(card, monkeypatch):
    """Four new keys in a row (the learning rates halved, as the trainer's
    milestones do), each step under a new key eager and captured, then a
    replay, at the benchmark's MSR-VTT widths: the memory the card holds
    stays within half a graph's pool of what it held after the first
    capture, where a pool kept a re-key would add one each time."""
    spec = harness.benchmark()
    run = harness.Run(SimpleNamespace(seed=KEY, seconds=0, trace=0), spec,
                      harness.cell_of(spec, "msrvtt-gan-b128"), 0.0, device=card)
    cfg, vocab = run.program_config("training"), run.config["vocab_size"]
    world = _World(cfg, vocab, card)
    batch = _batch(cfg, 16, vocab)
    gs, ds, lam = world.states()
    fn = make_gan_train_step(world.gen, world.disc, cfg)
    made = _counting_captures(monkeypatch)
    with monkeypatch.context() as m:  # an eager step: what the card holds without a graph
        m.setattr(steps, "step_graph_engaged", lambda dev, cfg, eps_gp: False)
        gs, ds, lam, _ = fn(gs, ds, lam, batch, KEY, 0.9)
    torch.cuda.synchronize(card)
    before = torch.cuda.memory_reserved(card)
    reserved = []
    for k in range(5):
        if k:
            for st in (gs, ds):
                st.set_learning_rate(st.optimizer.param_groups[0]["lr"] / 2)
        for _ in range(2):  # eager and a capture, then a replay
            gs, ds, lam, m = fn(gs, ds, lam, batch, KEY, 0.9)
        assert torch.isfinite(m["loss_D"])
        torch.cuda.synchronize(card)
        reserved.append(torch.cuda.memory_reserved(card))
    assert len(made) == 5
    pool = reserved[0] - before
    assert pool > 0, (before, reserved)
    assert max(reserved) - reserved[0] < pool / 2, (before, reserved)


@pytest.mark.cuda
@pytest.mark.parametrize("capturable_before", [False, True])
def test_a_checkpoint_of_capturable_adam_then_a_graphed_step_on_card(
        card, tmp_path, monkeypatch, capturable_before):
    """Two graphed steps, a checkpoint, a third step; against fresh states
    (plain or already capturable) restored from the checkpoint, which makes
    both Adam states capturable with their step counts on the card, as
    saved, then the third step by a new step function (eager, its warm-up,
    then captured): bitwise; then a fourth step each, the restored side's
    replayed."""
    cfg = tiny_test_config()
    world = _World(cfg, 50, card)
    batches = [_batch(cfg, 4, 50, seed=s) for s in (1, 2, 3)]
    gs, ds, lam = world.states()
    fn = make_gan_train_step(world.gen, world.disc, cfg)
    for b in batches[:2]:
        gs, ds, lam, _ = fn(gs, ds, lam, b, KEY, 0.9)
    assert gs.capturable and ds.capturable
    ckpt.save_train(str(tmp_path), 1, gs, ds, lam)
    want, want_t = [], []
    for b in (batches[2], batches[0]):
        gs, ds, lam, m = fn(gs, ds, lam, b, KEY, 0.9)
        want.append(m)
        want_t.append({k: v.clone() for k, v in
                       {**world.gen.state_dict(), **world.disc.state_dict()}.items()})

    gs2, ds2, lam2 = world.states()
    for st in (gs2, ds2):
        st.set_capturable(capturable_before)
    out = ckpt.restore_train(str(tmp_path), 1, gs2, ds2, lam2)
    gs2, ds2, lam2 = out["gen_state"], out["disc_state"], out["gan_lambda_state"]
    for st in (gs2, ds2):
        assert st.capturable
        assert {st.optimizer.state[p]["step"].device.type for p in st.params} == {"cuda"}
    made = _counting_captures(monkeypatch)
    fn2 = make_gan_train_step(world.gen, world.disc, cfg)
    for i, b in enumerate((batches[2], batches[0])):
        gs2, ds2, lam2, got = fn2(gs2, ds2, lam2, b, KEY, 0.9)
        assert ds2.step == 2 * cfg.num_D_visual + (i + 1) * cfg.num_D_visual
        for k in want[i]:
            assert torch.equal(got[k], want[i][k]), (i, k)
        for k, v in {**world.gen.state_dict(), **world.disc.state_dict()}.items():
            assert torch.equal(v, want_t[i][k]), (i, k)
    assert gs2.step == gs.step and ds2.step == ds.step and len(made) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["", *sorted(control.FAULTS)])
def test_planted_d_faults_are_caught_with_the_graph_on_card(card, monkeypatch, fault):
    """The benchmark's training run at tiny widths on the card, with the
    whole step's graph engaged: sound, it is correct; with D's Wasserstein
    term over half its batch or without its penalty (planted by name in
    train/steps.py, so in the captured step too), G's first step is
    untouched and D's numbers fail."""
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
