"""CUDA graphs: the one place in the package that captures one.

A `Graph` is a part of the program run eagerly once (`warm_up`), recorded
(`capture`, which runs nothing) and then run at the cost of one launch
(`replay`, which returns fn's outputs: the graph's memory, rewritten by
each replay). A card's graphs all warm up and capture on one side stream:
the default stream cannot capture, a stream that has run the work captures
faster, and the allocator reuses a stream's freed blocks and its cuBLAS
workspace only on that stream. The capture takes
`capture_error_mode="thread_local"` (a feed's thread may wait on its own
copies meanwhile) and, unlike `torch.cuda.graph`, leaves the caches as
they are: emptying them costs set-up time and frees nothing that the
graph's pool could use. Graphs given one `pool` share it.

A graph follows the generator it is given, `rng`: a replay draws from where
it stands and moves it on as the eager run would. `fork(rng)` is a generator
at rng's position that draws apart from it (remat's recompute,
ops/remat.py); outside a graph, rng's clone. A capture cannot make a
generator, so the warm-up makes the forks and notes how far rng had drawn
at each; the capture hands them out again in order, registered with the
graph, and each replay first sets them to rng's position plus that
distance. The capture must fork as its warm-up did: same shapes, same draws.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_forking = threading.local()  # the rule `fork` follows inside a warm-up or capture
_streams: Dict[torch.device, torch.cuda.Stream] = {}  # each card's side stream (module doc)


def fork(rng: torch.Generator) -> torch.Generator:
    """A generator at `rng`'s position that draws apart from it (module
    doc)."""
    rule = getattr(_forking, "rule", None)
    return rng.clone_state() if rule is None else rule(rng)


@contextlib.contextmanager
def _forks(rule: Optional[Callable[[torch.Generator], torch.Generator]]):
    _forking.rule = rule
    try:
        yield
    finally:
        _forking.rule = None


@contextlib.contextmanager
def _on(stream: Optional[torch.cuda.Stream]):
    """Work on `stream` after the current stream's, the current stream
    waiting for it after; without a stream (the CPU), where it is."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


class Graph:
    """A part of the program as one CUDA graph on `device` that follows the
    generator `rng`, if any (module doc); `pool`, another graph's, to share
    its memory. On the CPU only `warm_up` runs."""

    def __init__(self, device, rng: Optional[torch.Generator] = None, pool=None) -> None:
        device = torch.device(device)
        if device.type == "cuda" and device not in _streams:
            _streams[device] = torch.cuda.Stream(device)
        self.stream: Optional[torch.cuda.Stream] = _streams.get(device)
        self.rng, self.pool = rng, pool
        self.forks: List[Tuple[torch.Generator, int]] = []  # (fork, how far rng had drawn)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None

    def warm_up(self, fn: Callable[[], Any]) -> Any:
        """fn() eagerly on the graph's stream, the forks of `rng` noted;
        returns fn's outputs."""
        if self.stream is None:
            return fn()
        start = None if self.rng is None else self.rng.get_offset()
        self.forks = []

        def note(rng):
            if rng is not self.rng:
                raise ValueError("a fork of a generator that the graph does not follow")
            self.forks.append((rng.clone_state(), rng.get_offset() - start))
            return self.forks[-1][0]

        with _on(self.stream), _forks(note):
            return fn()

    def capture(self, fn: Callable[[], Any]) -> None:
        """fn recorded on the graph's stream after its warm-up (module doc):
        runs no kernel; the graph's pool becomes `pool`."""
        graph = torch.cuda.CUDAGraph()
        for g in ([] if self.rng is None else [self.rng]) + [f for f, _ in self.forks]:
            graph.register_generator_state(g)
        forks = iter(self.forks)

        def take(rng):
            f, _ = next(forks, (None, None))
            if f is None or rng is not self.rng:
                raise RuntimeError("the capture forks otherwise than its warm-up")
            return f

        with _on(self.stream), _forks(take):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                self.outputs = fn()
            finally:
                graph.capture_end()
        if next(forks, None) is not None:
            raise RuntimeError("the capture forks otherwise than its warm-up")
        self.graph, self.pool = graph, graph.pool()

    def replay(self) -> Any:
        """The graph run once, its forks set first; fn's outputs."""
        for f, drawn in self.forks:
            f.manual_seed(self.rng.initial_seed())
            f.set_offset(self.rng.get_offset() + drawn)
        self.graph.replay()
        return self.outputs
