"""Profiling / tracing hooks (counterpart of `dlsg_tpu/utils/profiler.py`).

- `span(name, args=None)`: a named phase of the program. While a
  `torch.profiler` trace runs, it is the user annotation `dlsg.<name>`
  (`record_function`) in that trace, on the clock of the kernels and copies
  it launched, so an idle stretch of the device can be put down to the phase
  the host was in; its host seconds also add to `span_totals()`. With no
  trace running it costs one check of the profiler's flag and returns a
  shared null context.
- `count(name, n=1)`: adds `n` to `counters()` while a trace runs;
  `count_device(name, value)` adds a device scalar without waiting for the
  device, and `flush_device_counts()` moves those sums into `counters()`
  with one wait (serve.py's `dlsg.serve.fetch`, which waits anyway);
  `reset_counters()` empties the tables.
- `start_trace(dir)` / `stop_trace(prof, dir)`: a `torch.profiler` trace
  (host ops, and CUDA kernels when a card is present), written into `dir`
  as a Chrome trace JSON (chrome://tracing, Perfetto). The trainer traces
  steps 3-5 of its first epoch.
- `Stopwatch`: named wall-clock spans with aggregate reporting, replacing the
  reference's scattered `time.time()` prints (run_gun.py:135,293-295,314-319);
  each is also a `span`.

The profiler records the annotations of the thread that started it (and
of the autograd threads it reaches), unless it was started with
`_ExperimentalConfig(profile_all_threads=True)`; `span_totals()` and
`counters()` take every thread's.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_counters: Dict[str, float] = {}
_span_totals: Dict[str, List[float]] = {}  # name -> [count, seconds]
_device_sums: Dict[str, torch.Tensor] = {}  # name -> a device scalar not yet counted


class _Span:
    """A `dlsg.`-named `record_function` that also adds its host seconds to
    the span table."""

    __slots__ = ("name", "record", "t0")

    def __init__(self, name: str, args) -> None:
        self.name = f"dlsg.{name}"
        self.record = torch.profiler.record_function(
            self.name, None if args is None else str(args))

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        self.record.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.record.__exit__(*exc)
        seconds = time.perf_counter() - self.t0
        with _lock:
            total = _span_totals.setdefault(self.name, [0, 0.0])
            total[0] += 1
            total[1] += seconds


def span(name: str, args=None):
    """The phase `dlsg.<name>` (module doc); `args` (e.g. a sequence number)
    is handed to `record_function` as its string."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, args)


def count(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name` while a trace runs."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def count_device(name: str, value: Callable[[], torch.Tensor]) -> None:
    """While a trace runs, add the device scalar `value()` to the counter
    `name` at the next `flush_device_counts()`; `value` is called only while
    a trace runs, so off a trace nothing is computed."""
    if _autograd_profiler._is_profiler_enabled:
        v = value().detach()
        with _lock:
            prev = _device_sums.get(name)
            _device_sums[name] = v if prev is None else prev + v


def flush_device_counts() -> None:
    """Add the device sums of `count_device` to the counters: one wait for
    the device when there are any, one check of a dict when there are none."""
    if not _device_sums:
        return
    with _lock:
        sums = list(_device_sums.items())
        _device_sums.clear()
    values = [float(v.item()) for _, v in sums]
    with _lock:
        for (k, _), v in zip(sums, values):
            _counters[k] = _counters.get(k, 0) + v


def counters() -> Dict[str, float]:
    """A copy of the counters added while traces ran."""
    with _lock:
        return dict(_counters)


def span_totals() -> Dict[str, Dict[str, float]]:
    """Each span entered while a trace ran, by its `dlsg.` name: `count`,
    and `seconds` of host time summed."""
    with _lock:
        return {k: {"count": n, "seconds": s} for k, (n, s) in _span_totals.items()}


def reset_counters() -> None:
    with _lock:
        _counters.clear()
        _span_totals.clear()
        _device_sums.clear()


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


class Stopwatch:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
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
