"""The port's tracing (utils/profiler.py): `span` and `count`, and the spans
and counters placed where the work happens (serve.py, evaluation/decode.py,
ops/beam_search.py, train/steps.py, train/optim.py, data/prefetch.py), read
from `torch.profiler` traces on the CPU.

With no trace running, a span is the shared null context and a count
changes nothing. Under a trace the spans nest in the order the work runs,
and what the program computes is bitwise what it computes untraced.
"""

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.data.prefetch import prefetch_to_device
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops.beam_search import beam_search
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.train import optim
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
from dlsg_tpu_torch.train.steps import make_gan_train_step
from dlsg_tpu_torch.utils import profiler
from dlsg_tpu_torch.vocab import Vocabulary

V = 40
B = 4


@pytest.fixture(autouse=True)
def fresh_tables():
    """Empty counter and span tables, and one intra-op thread (the suite runs
    several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset_counters()
    yield
    profiler.reset_counters()
    torch.set_num_threads(n)


def _trace(fn, all_threads=False):
    """Run `fn` under a CPU `torch.profiler` trace: (its result, the trace's
    `dlsg.` annotations as (name, thread, start, end), by start)."""
    cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads else None
    prof = profile(activities=[ProfilerActivity.CPU], experimental_config=cfg)
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    spans = sorted(
        ((e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.is_user_annotation() and e.name().startswith("dlsg.")),
        key=lambda s: s[2])
    return out, spans


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _names(spans):
    return [s[0] for s in spans]


# ---------------------------------------------------------------- off


def test_off_a_span_is_the_shared_null_context_and_a_count_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function constructed with no trace running")

    monkeypatch.setattr(profiler.torch.profiler, "record_function", refuse)
    assert profiler.span("serve.caption", (1, 4)) is profiler.span("decode.beam")
    with profiler.span("decode.beam") as s:
        assert s is None
    profiler.count("beam.hyp_steps", 5)
    assert profiler.counters() == {} and profiler.span_totals() == {}


def test_counts_and_span_seconds_only_while_a_trace_runs():
    profiler.count("c")
    with profiler.span("x"):
        pass

    def body():
        profiler.count("c", 2)
        profiler.count("c", 3)
        with profiler.span("x", 7):
            pass

    _, spans = _trace(body)
    assert _names(spans) == ["dlsg.x"]
    assert profiler.counters() == {"c": 5}
    totals = profiler.span_totals()
    assert list(totals) == ["dlsg.x"] and totals["dlsg.x"]["count"] == 1
    assert totals["dlsg.x"]["seconds"] >= 0.0
    profiler.reset_counters()
    assert profiler.counters() == {} and profiler.span_totals() == {}


# ---------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def captioner():
    cfg = tiny_test_config()
    vocab = Vocabulary.from_words(f"w{i}" for i in range(V))
    params = CapGnnModel(cfg, len(vocab), device="cpu").state_dict()
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(
        size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32)
    return Captioner.from_params(cfg, vocab, params, device="cpu"), frames, regions


def test_a_caption_call_nests_its_phases_in_order(captioner):
    cap, frames, regions = captioner
    want = cap.caption(frames, regions)
    got, spans = _trace(lambda: cap.caption(frames, regions))
    assert got == want
    assert _names(spans) == ["dlsg.serve.caption", "dlsg.serve.stage", "dlsg.decode.inputs",
                             "dlsg.decode.encode", "dlsg.decode.beam", "dlsg.serve.fetch",
                             "dlsg.serve.detok"]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(a[3] <= b[2] for a, b in zip(spans[1:], spans[2:]))  # one after another
    c = profiler.counters()
    assert 0 < c["beam.live_hyp_steps"] <= c["beam.hyp_steps"]
    assert c["beam.hyp_steps"] % (B * cap.cfg.beam_size) == 0


def test_a_greedy_caption_call_has_the_copy_span(captioner):
    cap, frames, regions = captioner
    _, spans = _trace(lambda: cap.caption(frames, regions, greedy=True))
    assert _names(spans) == ["dlsg.serve.caption", "dlsg.serve.stage", "dlsg.decode.inputs",
                             "dlsg.serve.fetch", "dlsg.serve.detok"]
    assert "beam.hyp_steps" not in profiler.counters()


# ---------------------------------------------------------------- beam


ENDS = (2, 4)  # the step at which each row's hypotheses emit <end>
END = 1


def _scripted_step(tokens, st):
    """Log-probs [G, 6] of a scripted decoder: each row's hypotheses prefer
    tokens 2 then 3 until the row's step ENDS[row], then <end>."""
    t, row = st["t"], st["row"]
    ending = t >= torch.as_tensor(ENDS)[row]
    lp = torch.full((tokens.shape[0], 6), -5.0)
    lp[:, 2], lp[:, 3], lp[:, END] = 0.0, -1.0, -10.0
    lp[ending] = -10.0
    lp[ending, END] = 0.0
    return lp, {"t": t + 1, "row": row}


def _scripted_beam(early_exit=True):
    state = {"t": torch.zeros(2, dtype=torch.int64), "row": torch.arange(2)}
    return beam_search(torch.zeros(2, dtype=torch.int64), state, _scripted_step, end_id=END,
                       max_steps=8, beam_size=2, early_exit=early_exit)


def test_beam_counts_each_step_that_runs_and_its_live_hypotheses():
    """Rows end at steps 2 and 4: loop steps 1-4 run (4 x B*beam = 16
    hypothesis steps), with 4, 4, 2, 2 live; step 5 finds none and exits.
    No step replays from a graph: the caller keeps none."""
    plain = _scripted_beam()
    traced, _ = _trace(_scripted_beam)
    assert profiler.counters() == {"beam.hyp_steps": 16, "beam.live_hyp_steps": 12,
                                   "beam.steps": 4, "beam.steps_graphed": 0}
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    ends = (plain[0][:, 0] == END).int().argmax(dim=-1)
    assert ends.tolist() == list(ENDS)
    full = _scripted_beam(early_exit=False)
    for a, b in zip(plain, full):
        assert torch.equal(a, b)


def test_beam_without_early_exit_reads_and_counts_nothing():
    _trace(lambda: _scripted_beam(early_exit=False))
    assert profiler.counters() == {}


# ---------------------------------------------------------------- GAN step


def _gan_setup():
    cfg = tiny_test_config(num_D_visual=3)
    gen, disc = CapGnnModel(cfg, V, device="cpu"), DiscV2(cfg, V, device="cpu")
    gs = optim.TrainState.create(gen, optim.make_optimizer(1e-3, cfg.grad_clip))
    ds = optim.TrainState.create(disc, optim.make_optimizer(1e-3))
    rng = np.random.default_rng(21)
    lengths = rng.integers(2, cfg.max_words + 1, size=B).astype(np.int32)
    caps = np.where(np.arange(cfg.max_words)[None] < lengths[:, None],
                    rng.integers(4, V, size=(B, cfg.max_words)), 0).astype(np.int32)
    batch = {
        "frames": rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(
            size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32),
        "captions": caps,
        "lengths": lengths,
    }
    step = make_gan_train_step(gen, disc, cfg)

    def run():
        _, _, _, m = step(gs, ds, init_lambda_state(0.01, device="cpu"), batch, 2, 0.9)
        return m

    return cfg, gen, disc, run


def test_gan_step_spans_its_phases_and_computes_the_same_traced():
    cfg, gen, disc, run = _gan_setup()
    want = run()
    want_p = {k: v.clone() for k, v in {**gen.state_dict(), **disc.state_dict()}.items()}
    cfg, gen, disc, run = _gan_setup()
    got, spans = _trace(run)
    got_p = {**gen.state_dict(), **disc.state_dict()}
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for k in want_p:
        assert torch.equal(want_p[k], got_p[k]), k

    names = _names(spans)
    subs = [s for s in spans if s[0] == "dlsg.gan.d_substep"]
    pens = [s for s in spans if s[0] == "dlsg.gan.penalty"]
    assert names[0] == "dlsg.gan.g_forward" and names.count("dlsg.gan.g_forward") == 1
    assert len(subs) == cfg.num_D_visual == len(pens)
    assert all(sum(_inside(p, s) for p in pens) == 1 for s in subs)
    (g_update,) = [s for s in spans if s[0] == "dlsg.gan.g_update"]
    assert g_update[2] >= subs[-1][3]
    updates = [s for s in spans if s[0] == "dlsg.optim.update"]
    assert len(updates) == cfg.num_D_visual + 1
    assert sum(_inside(u, g_update) for u in updates) == 1
    assert all(sum(_inside(u, s) for u in updates) == 1 for s in subs)


# ---------------------------------------------------------------- feed


def test_prefetch_stages_on_its_thread_and_waits_in_the_consumer():
    """Batch k's stage (on the feed's thread) ends before batch k's wait
    (in the consumer) does; the profiler sees the thread's spans when it
    profiles all threads, and the span table takes them either way."""
    batches = [{"frames": np.full((2, 3), k, np.float32), "captions": np.zeros((2, 4), np.int32)}
               for k in range(6)]
    got = []

    def consume():
        feed = prefetch_to_device(iter(batches), "cpu")
        try:
            for _ in range(3):
                got.append(next(feed))
        finally:
            feed.close()

    _, spans = _trace(consume, all_threads=True)
    assert [float(b["frames"][0, 0]) for b in got] == [0.0, 1.0, 2.0]
    stage = [s for s in spans if s[0] == "dlsg.data.stage"]
    wait = [s for s in spans if s[0] == "dlsg.data.wait"]
    assert len(wait) == 3 and len(stage) >= 3
    assert len({s[1] for s in wait}) == 1
    assert not {s[1] for s in stage} & {s[1] for s in wait}
    assert all(s[3] <= w[3] for s, w in zip(stage, wait))
    totals = profiler.span_totals()
    assert totals["dlsg.data.wait"]["count"] == 3
    assert totals["dlsg.data.stage"]["count"] == len(stage)


# ---------------------------------------------------------------- Stopwatch


def test_stopwatch_keeps_its_totals_and_appears_in_a_trace():
    sw = profiler.Stopwatch()
    with sw.span("train_step"):
        pass
    assert sw.counts["train_step"] == 1

    def body():
        with sw.span("train_step"):
            torch.ones(3).add_(1)

    _, spans = _trace(body)
    assert _names(spans) == ["dlsg.train_step"]
    assert sw.counts["train_step"] == 2 and sw.totals["train_step"] > 0.0
    assert "train_step: total" in sw.report()
