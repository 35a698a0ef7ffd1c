"""A tiny copy of a cell for the CPU tests: the configuration's structure
at test widths, and short traffic."""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace

from portbench import harness

TINY_MODEL = dict(
    visual_hidden_size=32, region_projected_size=32, query_hidden_size=32, decode_hidden_size=32,
    word_size=16, gan_word_size=16, num_proposals=5, num_obj=8, num_topk=3, max_frames=7,
    max_words=9, a_feature_size=24, m_feature_size=12, region_feature_size=20,
)
TINY_TRAFFIC = {
    "caption-b128": {"request_clips": 6, "pool_clips": 12, "check_clips": 8, "boxes": 10},
    "gan-b128": {"batch": 4},
}
LIMITS = {"token_mismatch_pct": 1e-9, "loss_gap": 1e-3, "grad_gap": 1e-3, "g_change_gap": 0.5,
          "d_change_gap": 0.5, "d_loss_gap": 1e-3, "lambda_gap": 0.0}


def tiny_run(cell_name: str, seed: int = 5, seconds: float = 1.0, trace: int = 0):
    """A `harness.Run` of the cell at tiny widths on the CPU."""
    spec = harness.benchmark()
    cell = harness.cell_of(spec, cell_name)
    config = copy.deepcopy(harness.load_json("configs", f"{cell['config']}.json"))
    config["model"].update(TINY_MODEL)
    config["vocab_size"] = 60
    config["length_model"] = {**config["length_model"], "end_bias": -10.0}
    config["mean_caption_words"] = 4
    config["limits"] = dict(LIMITS)
    traffic = {**harness.load_json("traffic", f"{cell['traffic']}.json"),
               **TINY_TRAFFIC.get(cell["traffic"], {})}
    args = SimpleNamespace(workload=cell_name, seed=seed, seconds=seconds, trace=trace)
    return harness.Run(args, spec, cell, time.perf_counter(), device="cpu", config=config,
                       traffic=traffic)
