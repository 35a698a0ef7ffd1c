"""Later beam steps replayed from one CUDA graph (ops/beam_search.py,
through utils/cuda_graph.py; the invariants that evaluation/decode.py hands
its step).

On the CPU: the rule that decides where the graph engages, and which steps
the decode hands the graphs; a graph's replays counted in the kernels'
launch counters; the graphed flow
itself with the capture replaced by a function that runs the graphed step
again at each replay, into the first replay's tensors, against the eager
loop, bitwise (predictions, scores, attention, `finished`), through one
graph for two decodes of other clips, after `load_state_dict` of new
weights, for a batch whose hypotheses all end early, and again after a new
owner; Kimi-VL's growing state, the int8 decode and a bare step function
make no graph; a head's buffer and its refill; the counters that
`beam_graph_share.b128` reads, and the benchmark's entry for it.

On the card (marker `cuda`; skipped without one; no JAX, so run without the
suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_beam_graph.py

graphed beam-5 decodes against eager ones, bitwise, at tiny widths (fp32
and bf16 fused heads, the plain head) and at the caption cell's MSR-VTT
widths and weights with the fp32 fused head (route `wgmma_tf32`), two
decodes of other clips through one graph, a decode after `load_state_dict`,
and a batch that ends early. Kimi-VL's decode on the card makes no beam
graph: tests/test_torch_kimi_vl_cuda.py.
"""

from dataclasses import asdict, replace
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import _make_beam_from_feats
from dlsg_tpu_torch.kernels.vocab_head import PreparedHead, split_head
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import beam_search as bs
from dlsg_tpu_torch.utils import cuda_graph, profiler
from portbench import harness

V = 40
END = 2
KEY = 3_900_001_801  # beyond 32 signed bits, as the benchmark's seeds are


@pytest.fixture(autouse=True)
def fresh_tables():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


@pytest.fixture(autouse=True)
def one_torch_thread():
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


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dst is not None:
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _counting_captures(monkeypatch, fake=False):
    """Wrap `cuda_graph.Graph.capture` to count captures; with `fake`, the
    capture makes the graph's replay run the graphed part again into the
    first replay's tensors (the CPU's stand-in for a graph)."""
    made = []
    real = cuda_graph.Graph.capture

    def capture(self, fn):
        made.append(len(made))
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
    """The graph engaged on the CPU where it would on a card; returns the
    fake captures made."""
    rule = bs.graph_engaged
    monkeypatch.setattr(bs, "graph_engaged", lambda dev, given, ret: rule("cuda", given, ret))
    return _counting_captures(monkeypatch, fake=True)


def _eager(monkeypatch):
    monkeypatch.setattr(bs, "graph_engaged", lambda dev, given, ret: False)


def _traced(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        return fn()
    finally:
        prof.stop()


def _model(cfg, device, seed=0):
    return CapGnnModel(cfg, V, generator=torch.Generator().manual_seed(seed), device=device).eval()


def _clips(cfg, n, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    fr = torch.randn(n, cfg.max_frames, cfg.feature_size, generator=g, device=device)
    rg = torch.randn(n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size, generator=g,
                     device=device)
    return fr, rg


@torch.inference_mode()
def _decode(fn, model, clips, steps):
    """fn's beam decode of the clips: (preds, log_probs, alphas, finished)."""
    obj, mot = model.encode(*clips)
    return fn(obj, mot, steps)


def _kimi(device):
    """Kimi-VL at its tiny config, with the CPU tests' kind of weights."""
    from dlsg_tpu_torch.models.kimi_vl_config import tiny_kimi_vl_config
    from portbench.reference import kimi_vl as ref

    kcfg = tiny_kimi_vl_config()
    g = torch.Generator().manual_seed(0)
    params = {}
    for k, s in ref.param_shapes(asdict(kcfg)).items():
        if k.endswith("norm.weight"):
            params[k] = torch.ones(s)
        elif k.endswith("bias"):
            params[k] = torch.randn(s, generator=g) * (1e-3 if "correction" in k else 0.0)
        else:
            params[k] = torch.randn(s, generator=g) * 0.15
    model = kcfg.build_generator()
    model.load_state_dict({k: v.to(device) for k, v in params.items()})
    feats = torch.randn(2, *kcfg.feature_shape, generator=g).to(device)
    return model.eval(), (feats, None)


def _assert_bitwise(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- CPU


_SAME = {"qh": torch.zeros(10, 4), "lc": torch.zeros(10, 6)}


@pytest.mark.parametrize("device,returned,engaged", [
    ("cuda", _SAME, True),
    ("cpu", _SAME, False),
    ("cuda", {"suffix": torch.zeros(10, 2, 3, 8)}, False),  # grows: [10, 2, 2, 8] given
    ("cuda", {"qh": torch.zeros(10, 4), "lc": torch.zeros(10, 6, dtype=torch.float64)}, False),
], ids=["card", "cpu", "growing-state", "dtype-changes"])
def test_where_the_beam_graph_engages(device, returned, engaged):
    given = ({"suffix": torch.zeros(10, 2, 2, 8)} if "suffix" in returned else _SAME)
    assert bs.graph_engaged(device, given, returned) is engaged


class _Handed(Exception):
    """Raised by a stand-in beam search once it has seen its arguments."""


@pytest.mark.parametrize("fused", ["on", "off"], ids=["fused-head", "plain-head"])
@pytest.mark.parametrize("head,handed", [("whole", True), ("split", False), ("int8", False)],
                         ids=["whole-head", "split-head", "int8"])
def test_only_a_step_without_collective_or_int8_is_handed_the_graphs(monkeypatch, fused, head,
                                                                     handed):
    """The caller's half of the rule (evaluation/decode.py): a head split
    over a model axis all-gathers inside the step, and the int8 decode runs
    `qmatmul`, so neither step is handed the graphs; the whole head's step,
    which runs no collective (under a data axis too), is."""
    from dlsg_tpu_torch.evaluation import decode as decode_mod

    quant = {"decode_quant": "int8"} if head == "int8" else {}
    cfg = tiny_test_config(use_fused_vocab_head=fused, **quant)
    model = _model(cfg, "cpu")
    if head == "split":
        monkeypatch.setattr(model, "decoder_vocab_shard", lambda: (0, V))
    seen = []

    def beam_search(*args, **kw):
        seen.append(kw["graphs"])
        raise _Handed

    monkeypatch.setattr(decode_mod, "beam_search", beam_search)
    fn = _make_beam_from_feats(model, cfg, 3)
    with pytest.raises(_Handed):
        _decode(fn, model, _clips(cfg, 4, "cpu", 1), cfg.max_words)
    assert seen == [fn.graphs if handed else None]


class _RecordingGraph:
    """The CPU's stand-in for `torch.cuda.CUDAGraph`: records nothing, runs
    nothing."""

    def register_generator_state(self, g):
        pass

    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass

    def pool(self):
        return None

    def replay(self):
        pass


def test_a_graphs_replays_count_the_launches_its_capture_recorded(monkeypatch):
    """The kernels' launch counters count what the card runs: a warm-up
    its launch, the capture (which launches nothing) none, each replay the
    launches that the capture's calls recorded, on their routes; counters
    that the graph does not touch stay."""
    from dlsg_tpu_torch import kernels
    from dlsg_tpu_torch.kernels import vocab_head

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordingGraph)

    def k1():  # what K1's wrapper counts for one call on the fp32 route
        vocab_head.LIBRARY.launches += 1
        vocab_head.ROUTE_LAUNCHES["wgmma_tf32"] += 1

    start = kernels.launch_counts()

    def moved():
        return {k: n - start[k] for k, n in kernels.launch_counts().items() if n != start[k]}

    try:
        graph = cuda_graph.Graph("cpu")
        graph.warm_up(k1)
        graph.capture(k1)
        assert moved() == {"vocab_head": 1, "vocab_head[wgmma_tf32]": 1}
        for _ in range(3):
            graph.replay()
        assert moved() == {"vocab_head": 4, "vocab_head[wgmma_tf32]": 4}
    finally:
        kernels.add_launches({k: -n for k, n in moved().items()})
    assert moved() == {}


@pytest.mark.parametrize("fused", ["on", "off"], ids=["fused-head", "plain-head"])
def test_the_graphed_flow_equals_the_eager_loop_on_the_cpu(monkeypatch, fused):
    """Two decodes of other clips through one graph (the first runs its
    first later step eagerly, its second as the graph's warm-up and
    replays from its third; the second decode replays from its first), each
    against its eager decode bitwise, with the attention that `return_alpha`
    reads; under a trace every later step counts in `beam.steps`, as many as
    the eager loop runs, and all but the first decode's first two in
    `beam.steps_graphed`."""
    cfg = tiny_test_config(use_fused_vocab_head=fused)
    model = _model(cfg, "cpu")
    clips = [_clips(cfg, 4, "cpu", s) for s in (1, 2)]
    with monkeypatch.context() as m:
        _eager(m)
        fn = _make_beam_from_feats(model, cfg, 3)
        want = _traced(lambda: [_decode(fn, model, c, cfg.max_words) for c in clips])
    steps = profiler.counters()["beam.steps"]
    profiler.reset_counters()
    made = _graphed_on_the_cpu(monkeypatch)
    fn = _make_beam_from_feats(model, cfg, 3)
    got = _traced(lambda: [_decode(fn, model, c, cfg.max_words) for c in clips])
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    assert len(made) == 1 and len(fn.graphs.graphs) == 1
    c = profiler.counters()
    assert c["beam.steps"] == steps > cfg.max_words
    assert c["beam.steps_graphed"] == steps - 2


def test_a_decode_after_new_weights_reads_them(monkeypatch):
    """A decode through a graph captured under other weights, after
    `load_state_dict` of new ones (copied into the same parameters): the
    eager decode of the new weights, bitwise."""
    cfg = tiny_test_config(use_fused_vocab_head="on")
    model = _model(cfg, "cpu", seed=0)
    new = {k: v.clone() for k, v in _model(cfg, "cpu", seed=7).state_dict().items()}
    clip = _clips(cfg, 4, "cpu", 3)
    made = _graphed_on_the_cpu(monkeypatch)
    fn = _make_beam_from_feats(model, cfg, 3)
    _decode(fn, model, clip, cfg.max_words)
    model.load_state_dict(new)
    got = _decode(fn, model, clip, cfg.max_words)
    assert len(made) == 1
    with monkeypatch.context() as m:
        _eager(m)
        want = _decode(_make_beam_from_feats(model, cfg, 3), model, clip, cfg.max_words)
    _assert_bitwise(got, want)


def test_a_new_owner_drops_the_graphs_and_captures_again(monkeypatch):
    """Parameters replaced by new tensors (another address, as after a move
    or an assigning load) drop the graphs that read the old ones: the next
    decode captures anew and equals the eager decode."""
    cfg = tiny_test_config(use_fused_vocab_head="on")
    model = _model(cfg, "cpu")
    clip = _clips(cfg, 4, "cpu", 3)
    made = _graphed_on_the_cpu(monkeypatch)
    fn = _make_beam_from_feats(model, cfg, 3)
    _decode(fn, model, clip, cfg.max_words)
    emb = model.decoder.step.word_embed
    emb.embedding = torch.nn.Parameter(emb.embedding.detach() * 1.5)
    got = _decode(fn, model, clip, cfg.max_words)
    assert len(made) == 2 and len(fn.graphs.graphs) == 1
    with monkeypatch.context() as m:
        _eager(m)
        want = _decode(_make_beam_from_feats(model, cfg, 3), model, clip, cfg.max_words)
    _assert_bitwise(got, want)


def test_a_head_function_put_in_the_kernels_place_is_captured_anew(monkeypatch):
    """A decode with another head function in `evaluation/decode.py` (a
    plain version swapped in, as a reference decode does) captures its own
    graph, which calls it, and the next decode with the first function
    captures again."""
    from dlsg_tpu_torch.evaluation import decode as decode_mod

    cfg = tiny_test_config(use_fused_vocab_head="on")
    model = _model(cfg, "cpu")
    clip = _clips(cfg, 4, "cpu", 3)
    made = _graphed_on_the_cpu(monkeypatch)
    fn = _make_beam_from_feats(model, cfg, 3)
    want = _decode(fn, model, clip, cfg.max_words)
    real, calls = decode_mod.vocab_head_topk, []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(decode_mod, "vocab_head_topk", counted)
        swapped = _decode(fn, model, clip, cfg.max_words)
    # each step calls it once, the warm-up's and the replays too
    assert len(made) == 2 and len(calls) == cfg.max_words
    again = _decode(fn, model, clip, cfg.max_words)
    assert len(made) == 3
    _assert_bitwise(swapped, want)
    _assert_bitwise(again, want)


ENDS = (3, 5)  # the loop step at which each row's hypotheses all take <end>


def _scripted(tokens, st, inv):
    """Log-probs [G, 6] of a scripted decoder whose state keeps its shapes:
    each row's hypotheses prefer tokens 3 then 4 until the row's step
    inv["ends"][row], then <end>; aux, the step count."""
    t, row = st["t"], st["row"]
    ending = (t >= inv["ends"][row])[:, None]
    lp = torch.full((tokens.shape[0], 6), -5.0, device=t.device)
    lp[:, 3], lp[:, 4], lp[:, END] = 0.0, -1.0, -10.0
    forced = torch.full_like(lp, -10.0)
    forced[:, END] = 0.0
    return torch.where(ending, forced, lp), {"t": t + 1, "row": row}, t.float()[:, None]


def _scripted_beam(graphs, device="cpu", max_steps=9):
    state = {"t": torch.zeros(2, dtype=torch.int64, device=device),
             "row": torch.arange(2, device=device)}
    inv = {"ends": torch.as_tensor(ENDS, device=device)}
    return bs.beam_search(torch.zeros(2, dtype=torch.int64, device=device), state, _scripted,
                          end_id=END, max_steps=max_steps, beam_size=2, normalize=True,
                          return_finished=True, invariants=inv, graphs=graphs)


def test_a_batch_that_ends_early_stops_replaying_where_the_eager_loop_stops(monkeypatch):
    """Rows end at loop steps 3 and 5, so loop steps 1-5 run: the first
    decode runs its first later step eagerly, its second as the graph's
    warm-up and replays from the third, the second replays all five, and
    both stop where the eager loop does,
    with its predictions, scores, aux and `finished`."""
    with monkeypatch.context() as m:
        _eager(m)
        want = _traced(lambda: _scripted_beam(bs.StepGraphs()))
    eager_counts = profiler.counters()
    assert eager_counts["beam.steps"] == 5 and eager_counts["beam.steps_graphed"] == 0
    profiler.reset_counters()
    made = _graphed_on_the_cpu(monkeypatch)
    graphs = bs.StepGraphs()
    first = _traced(lambda: _scripted_beam(graphs))
    assert profiler.counters()["beam.steps_graphed"] == 3
    second = _traced(lambda: _scripted_beam(graphs))
    c = profiler.counters()
    assert (c["beam.steps"], c["beam.steps_graphed"]) == (10, 8)
    assert c["beam.hyp_steps"] == 2 * eager_counts["beam.hyp_steps"]
    assert len(made) == 1
    for got in (first, second):
        _assert_bitwise(got, want)
    assert want[3].all()


def test_a_bare_step_function_keeps_no_graph():
    """Graphs need the step's invariants: a step function that takes its
    tokens and state alone cannot be handed the graph's copies."""
    with pytest.raises(ValueError, match="invariants"):
        bs.beam_search(torch.zeros(2, dtype=torch.int64), {"t": torch.zeros(2)},
                       lambda tok, st: (torch.zeros(2, 6), st), end_id=END, max_steps=3,
                       beam_size=2, graphs=bs.StepGraphs())


@pytest.mark.parametrize("kind", ["kimi-vl", "int8"])
def test_decodes_that_the_graph_does_not_serve_capture_nothing(monkeypatch, kind):
    """Kimi-VL's beam state, a suffix that grows a token a step, shows at
    its first later step that no graph serves it, before any warm-up; the
    int8 decode is kept eager. Neither captures, and each equals its
    eager decode."""
    made = _graphed_on_the_cpu(monkeypatch)
    if kind == "kimi-vl":
        model, clips = _kimi("cpu")
        cfg, steps = tiny_test_config(use_fused_vocab_head="on", max_words=5), 5
    else:
        cfg = tiny_test_config(use_fused_vocab_head="on", decode_quant="int8")
        model = _model(cfg, "cpu")
        clips, steps = _clips(cfg, 4, "cpu", 2), cfg.max_words
    fn = _make_beam_from_feats(model, cfg, 3)
    got = _decode(fn, model, clips, steps)
    assert made == [] and fn.graphs.graphs == {}
    with monkeypatch.context() as m:
        _eager(m)
        want = _decode(_make_beam_from_feats(model, cfg, 3), model, clips, steps)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("head", ["fp32-split", "plain"])
def test_a_heads_buffer_holds_its_layout_and_copy_refills_it(head):
    """`PreparedHead.empty_like`: storage of its own in the head's layout;
    `copy_` refills it from another decode's head."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(7, 11, generator=g).t()  # [11, 7]: a transposed view, as the decoder's
    src = split_head(w) if head == "fp32-split" else PreparedHead(w, None, None)
    buf = src.empty_like()
    assert buf.w.data_ptr() != src.w.data_ptr() and buf.w.stride() == src.w.stride()
    assert (buf.parts is None) == (src.parts is None)
    assert bs._layout(buf) == bs._layout(src)
    buf.copy_(src)
    assert torch.equal(buf.w, src.w)
    if src.parts is not None:
        assert buf.parts.data_ptr() != src.parts.data_ptr() and torch.equal(buf.parts, src.parts)


def test_invariant_buffers_are_shared_by_path_and_layout():
    """What two keys' invariants hold alike (weights) gets one buffer, what
    differs by batch one each; a buffer keeps its tensor's strides."""
    shared = {}
    w = torch.randn(6, 4).t()
    a = bs._buffers({"pre": {"K": torch.zeros(6, 3), "W": w}}, shared)
    b = bs._buffers({"pre": {"K": torch.zeros(12, 3), "W": w}}, shared)
    assert a["pre"]["W"] is b["pre"]["W"] and a["pre"]["K"] is not b["pre"]["K"]
    assert a["pre"]["W"].stride() == w.stride() and len(shared) == 3


def test_the_counters_on_the_cpu_and_beam_graph_share_reads_zero():
    """On the CPU no step replays: under a trace `beam.steps` counts the
    later steps, `beam.steps_graphed` none, and the benchmark's
    `beam_graph_share.b128` reads 0."""
    cfg = tiny_test_config(use_fused_vocab_head="on")
    model = _model(cfg, "cpu")
    fn = _make_beam_from_feats(model, cfg, 3)
    _traced(lambda: _decode(fn, model, _clips(cfg, 4, "cpu", 1), cfg.max_words))
    c = profiler.counters()
    assert c["beam.steps"] == cfg.max_words - 1 and c["beam.steps_graphed"] == 0
    entry = harness.load_json("metrics", "beam_graph_share.b128.json")
    assert harness.load_module("readers", entry["reader"]).read({}, **entry["args"]) == 0.0


@pytest.mark.parametrize("graphed,total,share", [(None, None, None), (0, 24, 0.0), (23, 24, 95.833),
                                                 (24, 24, 100.0)])
def test_beam_graph_share_is_the_benchmark_entry_over_the_two_counters(graphed, total, share):
    """`beam_graph_share.b128` as the benchmark declares it: the program
    counter reader over `beam.steps_graphed` / `beam.steps`, in the caption
    cell; silent where nothing was counted (as in a program without the
    counters)."""
    (entry,) = [m for m in harness.benchmark()["per_layer"] if m["name"] == "beam_graph_share.b128"]
    assert entry == {"name": "beam_graph_share.b128", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "model step (evaluation/decode.py, models/)",
                     "moves": "captions_per_s", "workloads": ["msrvtt-caption-b128"]}
    spec = harness.load_json("metrics", "beam_graph_share.b128.json")
    assert spec == {"reader": "program_counter",
                    "args": {"num": "beam.steps_graphed", "den": "beam.steps"}}
    if total is not None:
        def count():
            profiler.count("beam.steps", total)
            profiler.count("beam.steps_graphed", graphed)
        _traced(count)
    value = harness.load_module("readers", spec["reader"]).read({}, **spec["args"])
    assert value == (None if share is None else pytest.approx(share, abs=1e-3))


# ---------------------------------------------------------------- card


def _msrvtt_captioner(device):
    """The caption cell's Captioner (MSR-VTT widths, the cell's weights,
    fp32 with the fused head) and a maker of its clips."""
    from portbench import inputs, serving

    spec = harness.benchmark()
    run = harness.Run(SimpleNamespace(seed=KEY, seconds=0, trace=0), spec,
                      harness.cell_of(spec, "msrvtt-caption-b128"), 0.0, device=device)
    md, tr = run.model_dict("serving"), run.traffic
    T = md["max_frames"]
    shapes = ((T, md["a_feature_size"] + md["m_feature_size"]),
              (T, tr["boxes"], md["region_feature_size"]))

    def clips(n, index):
        return inputs.clip_pool(n, *shapes, KEY, device, index)

    return serving.make_captioner(run, device), clips


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    {"use_fused_vocab_head": "on"},
    {"use_fused_vocab_head": "on", "compute_dtype": "bfloat16"},
    {"use_fused_vocab_head": "off"},
], ids=["tiny-fp32-head", "tiny-bf16-head", "tiny-plain-head"])
def test_graphed_beam_decodes_equal_eager_ones_on_card(card, monkeypatch, fields):
    """Beam-5 decodes of two batches of other clips through one graph,
    then of the first batch after `load_state_dict` of new weights: each
    the eager decode's predictions, scores, attention and `finished`,
    bitwise; one capture in all."""
    cfg = replace(tiny_test_config(), **fields)
    model = _model(cfg, card, seed=0)
    new = {k: v.clone() for k, v in _model(cfg, card, seed=7).state_dict().items()}
    old = {k: v.clone() for k, v in model.state_dict().items()}
    clips = [_clips(cfg, 8, card, s) for s in (1, 2)]
    made = _counting_captures(monkeypatch)
    fn = _make_beam_from_feats(model, cfg, 5)
    got = [_decode(fn, model, c, cfg.max_words) for c in clips]
    model.load_state_dict(new)
    got.append(_decode(fn, model, clips[0], cfg.max_words))
    assert len(made) == 1 and len(fn.graphs.graphs) == 1
    _eager(monkeypatch)
    eager = _make_beam_from_feats(model, cfg, 5)
    model.load_state_dict(old)
    want = [_decode(eager, model, c, cfg.max_words) for c in clips]
    model.load_state_dict(new)
    want.append(_decode(eager, model, clips[0], cfg.max_words))
    for g, w in zip(got, want):
        _assert_bitwise(g, w)


@pytest.mark.cuda
def test_graphed_beam_decodes_equal_eager_ones_at_msrvtt_widths_on_card(card, monkeypatch):
    """The caption cell's decode (MSR-VTT widths and weights, 128 clips,
    beam 5, K1's fp32 route `wgmma_tf32`): two requests of other clips
    through one graph, each the eager decode bitwise; the captions end
    early, as the cell's do, at the eager loop's step."""
    from dlsg_tpu_torch.kernels.vocab_head import ROUTE_LAUNCHES

    cap, clips = _msrvtt_captioner(card)
    model, cfg = cap.model, cap.cfg
    batches = [clips(128, i) for i in (0, 1)]
    made = _counting_captures(monkeypatch)
    fn = _make_beam_from_feats(model, cfg, cfg.beam_size)
    tf32 = ROUTE_LAUNCHES["wgmma_tf32"]
    got = _traced(lambda: [_decode(fn, model, b, cfg.max_words) for b in batches])
    graphed_k1 = ROUTE_LAUNCHES["wgmma_tf32"] - tf32
    c = profiler.counters()
    assert len(made) == 1
    assert c["beam.steps_graphed"] == c["beam.steps"] - 2
    assert c["beam.steps"] < 2 * (cfg.max_words - 1)  # an early exit
    profiler.reset_counters()
    _eager(monkeypatch)
    eager = _make_beam_from_feats(model, cfg, cfg.beam_size)
    tf32 = ROUTE_LAUNCHES["wgmma_tf32"]
    want = _traced(lambda: [_decode(eager, model, b, cfg.max_words) for b in batches])
    assert profiler.counters()["beam.steps"] == c["beam.steps"]
    # K1 once a step (a decode's first and each later one), replays counted
    assert graphed_k1 == ROUTE_LAUNCHES["wgmma_tf32"] - tf32 == c["beam.steps"] + 2
    for g, w in zip(got, want):
        _assert_bitwise(g, w)


@pytest.mark.cuda
def test_a_batch_that_ends_early_stops_replaying_on_card(card, monkeypatch):
    """The scripted beam on the card: the graphed decodes stop at the eager
    loop's step, with its outputs, bitwise."""
    _eager(monkeypatch)
    want = _scripted_beam(bs.StepGraphs(), card)
    monkeypatch.undo()
    made = _counting_captures(monkeypatch)
    graphs = bs.StepGraphs()
    got = [_traced(lambda: _scripted_beam(graphs, card)) for _ in range(2)]
    c = profiler.counters()
    assert len(made) == 1 and (c["beam.steps"], c["beam.steps_graphed"]) == (10, 8)
    for g in got:
        _assert_bitwise(g, want)
