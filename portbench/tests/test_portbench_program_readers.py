"""The readers of the program's own counters and spans
(`readers/program_counter.py`, `readers/program_span.py`): their arithmetic,
their silence where the program has nothing to read (as a program without
the tables has), and both cells' traced lines at tiny widths on the CPU;
`phases.py`'s table of a trace's annotations."""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from dlsg_tpu_torch.utils import profiler
from portbench import harness, phases, trace
from portbench.tests.test_portbench_harness import Ev
from portbench.tests.tiny import tiny_run

counter = harness.load_module("readers", "program_counter")
span = harness.load_module("readers", "program_span")


@pytest.fixture(autouse=True)
def fresh_tables():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


def _traced(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        fn()
    finally:
        prof.stop()


def test_counter_ratio_and_its_silence():
    assert counter.read({}, "live", "all") is None  # nothing counted
    _traced(lambda: (profiler.count("all", 40), profiler.count("live", 30)))
    assert counter.read({}, "live", "all") == pytest.approx(75.0)
    assert counter.read({}, "live", "all", scale=1.0) == pytest.approx(0.75)
    assert counter.read({}, "other", "all") is None
    assert counter.read({}, "live", "other") is None
    _traced(lambda: profiler.count("zero", 0))
    assert counter.read({}, "live", "zero") is None


def test_span_ms_per_span_or_per_unit_and_its_silence():
    records = {"counters": {"steps": 4, "none": 0}}
    assert span.read(records, "dlsg.data.wait") is None

    def body():
        for _ in range(2):
            with profiler.span("data.wait"):
                pass

    _traced(body)
    seconds = profiler.span_totals()["dlsg.data.wait"]["seconds"]
    assert span.read(records, "dlsg.data.wait") == pytest.approx(1e3 * seconds / 2)
    assert span.read(records, "dlsg.data.wait", per="steps") == pytest.approx(1e3 * seconds / 4)
    assert span.read(records, "dlsg.data.wait", per="none") is None
    assert span.read(records, "dlsg.data.stage") is None


def test_a_program_without_the_tables_gives_nothing(monkeypatch):
    _traced(lambda: profiler.count("all", 1))
    monkeypatch.delattr(profiler, "counters")
    monkeypatch.delattr(profiler, "span_totals")
    assert counter.read({}, "all", "all") is None
    assert span.read({"counters": {}}, "dlsg.data.wait") is None


@pytest.mark.parametrize("cell, names", [
    ("msrvtt-caption-b128", ["beam_live_share.b128"]),
    ("msrvtt-gan-b128", ["data_wait_ms.train", "feed_stage_ms.train"]),
])
def test_a_traced_tiny_run_reads_the_programs_metrics(cell, names):
    r = tiny_run(cell, seconds=0.5, trace=1)
    out = harness.load_module("drivers", r.traffic["driver"]).run(r)
    line, _ = harness.result_line(r, out, {"platform": "cpu"})
    assert line["correct"] is True
    for n in names:
        v = line["metrics"][n]["value"]
        assert v > 0.0 and (v <= 100.0 or line["metrics"][n]["unit"] == "ms"), (n, v)


def test_phase_table_of_nested_and_straddling_annotations():
    ev = [Ev(trace.WINDOW, False, 0, 1000, True), Ev("k1", True, 100, 200), Ev("k2", True, 600, 100),
          Ev("dlsg.a", False, 50, 400, True), Ev("dlsg.a", True, 50, 400, True),  # and its mirror
          Ev("dlsg.b", False, 200, 200, True), Ev("dlsg.c", False, 900, 300, True),
          Ev("dlsg.d", False, 1100, 50, True), Ev("aten::mm", False, 100, 50)]
    t = phases.annotations(ev)
    assert set(t) == {"dlsg.a", "dlsg.b", "dlsg.c"}  # d lies past the window; ops are no phase
    assert t["dlsg.a"]["count"] == 1 and t["dlsg.a"]["seconds"] == pytest.approx(400e-9)
    assert t["dlsg.a"]["idle_s"] == pytest.approx(200e-9) and t["dlsg.a"]["idle_share"] == 50.0
    assert t["dlsg.b"]["idle_s"] == pytest.approx(100e-9)  # nested: busy 200-300
    assert t["dlsg.c"]["seconds"] == pytest.approx(100e-9) and t["dlsg.c"]["idle_share"] == 100.0
