"""The data-parallel GAN driver on the CPU: four rank processes over gloo at
tiny widths, held to the reference's steps over the global batch."""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import numpy as np

from portbench import harness
from portbench.tests.tiny import LIMITS, TINY_MODEL

CELL = {"name": "msrvtt-gan-ddp4", "config": "dlsg-msrvtt", "traffic": "gan-ddp4-b128", "chips": 4}


def tiny_ddp_run(seed: int = 11, seconds: float = 1.0, trace: int = 0) -> harness.Run:
    config = copy.deepcopy(harness.load_json("configs", f"{CELL['config']}.json"))
    config["model"].update(TINY_MODEL)
    config["vocab_size"] = 60
    config["length_model"] = {**config["length_model"], "end_bias": -10.0}
    config["mean_caption_words"] = 4
    config["limits"] = dict(LIMITS)
    traffic = {**harness.load_json("traffic", f"{CELL['traffic']}.json"), "batch": 2}
    args = SimpleNamespace(workload=CELL["name"], seed=seed, seconds=seconds, trace=trace)
    return harness.Run(args, harness.benchmark(), CELL, time.perf_counter(), device="cpu",
                       config=config, traffic=traffic)


def run_driver(r):
    return harness.load_module("drivers", r.traffic["driver"]).run(r)


def test_the_cells_files_are_found_by_name():
    traffic = harness.load_json("traffic", f"{CELL['traffic']}.json")
    assert (harness.BENCH / "drivers" / f"{traffic['driver']}.py").exists()
    assert traffic["ranks"] == 4 and traffic["batch"] == 128


def test_a_sound_data_parallel_run_is_correct():
    r = tiny_ddp_run(trace=1)
    out = run_driver(r)
    assert all(c.ok() for c in out.checks), out.checks
    c = out.records["counters"]
    assert c["clips"] == 4 * 2 * c["steps"] and c["steps"] >= 2
    assert np.isfinite(out.e2e["train_clips_per_s"]) and c["plain_window_s"] > 0


def test_rank_0_with_its_summed_gradients_halved_is_not_correct(monkeypatch):
    """Rank 0 (this process) halves what the all-reduce summed: its
    generator's first gradient and changes leave the reference's."""
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.train import steps

    def halved(grads):
        return [g / 2 for g in dist.all_reduce_grads(grads)]

    monkeypatch.setattr(steps, "all_reduce_grads", halved)
    out = run_driver(tiny_ddp_run(seed=12))
    checks = {c.name: c for c in out.checks}
    assert not checks["grad_gap"].ok(), out.checks


def test_one_rank_is_the_single_card_step():
    """A world of one: the same numbers as the single-process driver's
    check, with no rank process started."""
    r = tiny_ddp_run(seed=13)
    r.traffic["ranks"] = 1
    out = run_driver(r)
    assert all(c.ok() for c in out.checks), out.checks
