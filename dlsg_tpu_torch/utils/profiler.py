"""Profiling / tracing hooks (counterpart of `dlsg_tpu/utils/profiler.py`).

- `trace(dir)`: context manager around a `torch.profiler` trace (host ops,
  and CUDA kernels when a card is present), written into `dir` as a Chrome
  trace JSON (chrome://tracing, Perfetto). `start_trace`/`stop_trace` are
  its two halves, for regions that are not one block (the trainer traces
  steps 3-5 of its first epoch).
- `Stopwatch`: named wall-clock spans with aggregate reporting, replacing the
  reference's scattered `time.time()` prints (run_gun.py:135,293-295,314-319).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def start_trace(log_dir: str) -> torch.profiler.profile:
    """Start a trace; `stop_trace(prof, log_dir)` ends and writes it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop `prof` and write its Chrome trace into `log_dir`; returns the path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


class Stopwatch:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: total {tot:.3f}s over {n} spans ({tot / n:.4f}s avg)")
        return "\n".join(lines)
