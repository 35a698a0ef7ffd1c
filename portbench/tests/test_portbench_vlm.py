"""The Kimi-VL cell on the CPU at tiny widths: its files found by name, its
metrics through their readers, `vlm_work`'s FLOPs against what
`FlopCounterMode` counts over the plain reference, and the driver's runs,
sound ones correct and broken ones not.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, vlm_work
from portbench.reference import kimi_vl as ref

CELL = {"name": "kimivl-caption-b32", "config": "kimi-vl-a3b", "traffic": "vlm-caption-b32", "chips": 1}


def tiny_arch() -> dict:
    from dlsg_tpu_torch.models.kimi_vl_config import tiny_kimi_vl_config

    c = dataclasses.asdict(tiny_kimi_vl_config())
    c.pop("prompt_ids")
    c["merge_kernel_size"] = list(c["merge_kernel_size"])
    return c


def tiny_vlm_run(seed: int = 5, seconds: float = 0.5, trace: int = 0) -> harness.Run:
    config = copy.deepcopy(harness.load_json("configs", "kimi-vl-a3b.json"))
    config.update(tiny_arch(), initializer_range=0.15)
    config["serving"].update(test_batch_size=4, max_words=5)
    config["limits"] = {"seq_logprob_gap": 0.02, "first_step_gap": 0.1, "decode_latent_gap": 0.02,
                        "rerun_token_mismatch_pct": 0.0}
    traffic = {**harness.load_json("traffic", "vlm-caption-b32.json"),
               "request_clips": 4, "pool_clips": 8, "check_clips": 2, "prompt_words": 4,
               "check_requests": 2}
    args = SimpleNamespace(workload=CELL["name"], seed=seed, seconds=seconds, trace=trace)
    spec = harness.benchmark()
    return harness.Run(args, spec, CELL, time.perf_counter(), device="cpu", config=config,
                       traffic=traffic)


def run_driver(r):
    return harness.load_module("drivers", r.traffic["driver"]).run(r)


@pytest.fixture(autouse=True)
def one_thread():
    from dlsg_tpu_torch.utils import profiler

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset_counters()
    yield
    profiler.reset_counters()
    torch.set_num_threads(n)


def test_the_cells_files_are_found_by_name():
    cfg = harness.load_json("configs", f"{CELL['config']}.json")
    traffic = harness.load_json("traffic", f"{CELL['traffic']}.json")
    assert (harness.BENCH / "drivers" / f"{traffic['driver']}.py").exists()
    assert traffic["pool_clips"] % traffic["request_clips"] == 0
    assert cfg["n_routed_experts"] == 64 and cfg["vocab_size"] == 163840 and cfg["num_hidden_layers"] == 27
    shapes = ref.param_shapes(cfg)
    params = sum(torch.Size(s).numel() for s in shapes.values())
    assert 15.9e9 < params < 16.1e9  # the whole language model and projector


@pytest.mark.parametrize("name, records, want", [
    ("vlm_mfu.vlm", {"counters": {"plain_model_flops": 989e12, "plain_window_s": 4.0}}, 25.0),
    ("k1_roofline.vlm", {"trace": {"kernels": {"vh_wgmma_kernel<false, 128, 1>": 2e-3, "merge_kernel": 0.0},
                                   "counts": {"vh_wgmma_kernel<false, 128, 1>": 3}},
                         "decodes": {"rows": 32, "count": 1, "beam": 5, "H": 2048, "V": 163840,
                                     "w_bytes": 2}}, None),
    ("idle_share.vlm", {"counters": {}, "trace": {"window_s": 10.0, "busy_s": 9.2, "kernels": {}}}, 8.0),
    ("h2d_ms.vlm", {"counters": {"requests": 4}, "trace": {
        "window_s": 10.0, "busy_s": 9.2, "kernels": {"Memcpy HtoD (Pinned -> Device)": 0.14, "k": 1.0}}}, 35.0),
])
def test_each_new_metric_through_its_reader(name, records, want):
    from portbench import work

    entry = harness.load_json("metrics", f"{name}.json")
    got = harness.load_module("readers", entry["reader"]).read(records, **entry.get("args", {}))
    if want is None:  # one first step at G = 32, two later ones at G = 160
        want = 100 * (work.k1(32, 2048, 163840, 5, 2).bound_s()
                      + 2 * work.k1(160, 2048, 163840, 5, 2).bound_s()) / 2e-3
    assert got == pytest.approx(want)
    assert harness.load_module("readers", entry["reader"]).read(
        {"counters": {}, "trace": {"kernels": {}, "counts": {}, "window_s": 0.0},
         "decodes": records.get("decodes")}, **entry.get("args", {})) is None


def test_moe_peak_load_through_its_reader():
    from torch.profiler import ProfilerActivity, profile

    from dlsg_tpu_torch.utils import profiler

    entry = harness.load_json("metrics", "moe_peak_load.vlm.json")
    reader = harness.load_module("readers", entry["reader"])
    assert reader.read({}, **entry["args"]) is None  # nothing counted
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    profiler.count("moe.assignments", 600)
    profiler.count_device("moe.busiest", lambda: torch.tensor(640 * 2))
    prof.stop()
    assert reader.read({}, **entry["args"]) is None  # the device sum not yet flushed
    profiler.flush_device_counts()
    assert reader.read({}, **entry["args"]) == pytest.approx(100 * 1280 / 600)


def test_prefill_and_step_flops_match_the_flop_counter():
    from dlsg_tpu_torch.models.kimi_vl_config import START_ID

    c = {**tiny_arch(), "prompt_ids": [7, 9, START_ID]}
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s, generator=g) * 0.1 for k, s in ref.param_shapes(c).items()}
    feats = torch.randn(2, c["frames"], c["tokens_per_frame"], 4, c["vision_hidden_size"], generator=g)
    visual = c["frames"] * c["tokens_per_frame"]
    for extra in (0, 3):  # the prefix alone, then with three caption tokens
        toks = torch.tensor([c["prompt_ids"] + [5] * extra] * 2)
        L = visual + toks.shape[1]
        with FlopCounterMode(display=False) as m:
            ref.forward(p, c, feats, toks, first=L - 1)
        # the reference computes full S x S scores; the yardstick the causal half
        full = vlm_work.key_flops(c) * (L * L - L * (L + 1) / 2)
        want = 2 * (vlm_work.prefill_flops(c, visual, L) + full + 2 * c["hidden_size"] * c["vocab_size"])
        assert m.get_total_flops() == pytest.approx(want)
    assert vlm_work.step_flops(c, 10) - vlm_work.step_flops(c, 9) == vlm_work.key_flops(c)


def test_a_sound_run_is_correct_and_reads_its_metrics(monkeypatch):
    from dlsg_tpu_torch.models import kimi_vl

    monkeypatch.setattr(kimi_vl, "PREFILL_ROWS", 16)  # the prefill's MLPs in several chunks
    r = tiny_vlm_run(trace=1)
    out = run_driver(r)
    out.trace = {"window_s": 1.0, "busy_s": 0.5, "kernels": {}, "counts": {}, "idle_gaps": {}}
    line, _ = harness.result_line(r, out, {"platform": "cpu"})
    assert line["correct"] is True, line["checks"]
    assert 0.0 < line["metrics"]["moe_peak_load.vlm"]["value"]
    assert 0.0 < line["metrics"]["vlm_mfu.vlm"]["value"]
    assert "k1_roofline.vlm" not in line["metrics"]  # no device trace on the CPU
    assert line["checks"]["rerun_token_mismatch_pct"]["value"] == 0.0
    c = out.records["counters"]
    assert c["checked_clips"] == 4
    assert 0.0 <= c["routing_disagree_pct"] < 50.0


@pytest.mark.parametrize("fault, caught_by", [
    ("altered_caption", "rerun_token_mismatch_pct"), ("k_pe_unrotated", "decode_latent_gap"),
    ("top5", "first_step_gap"), ("no_shared", "first_step_gap"), ("e4m3", "seq_logprob_gap"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, caught_by):
    """A served token altered, or a fault of `vlm_control.py` planted in the
    program (the decode window's fault needs a prefix over 2048 tokens),
    and the number that reads it over its limit."""
    from dlsg_tpu_torch.serve import Captioner
    from portbench import vlm_control

    planted = contextlib.nullcontext()
    if fault == "altered_caption":
        orig = Captioner.caption

        def caption(self, frames, regions, greedy=False):
            return [" ".join(["w5"] + t.split()[1:]) for t in orig(self, frames, regions, greedy)]

        monkeypatch.setattr(Captioner, "caption", caption)
    else:
        planted = vlm_control.fault(fault)
    with planted:
        out = run_driver(tiny_vlm_run(seed=6))
    assert not all(ch.ok() for ch in out.checks), out.checks
    assert not next(ch for ch in out.checks if ch.name == caught_by).ok(), out.checks
