"""The traced window: `torch.profiler` over the measured loop, reduced to
what the per-layer readers take (device busy time, device time by kernel
name, host-to-device copies, idle gaps by what the host was doing).

The window is marked by a `portbench.window` annotation, so busy time and
the window's length come from one clock. Device intervals are merged
before they are summed: concurrent kernels count once.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "portbench.window"
TOP = 10  # entries kept in each list of the breakdown
LABELLED_GAPS = 2000  # the longest idle gaps that get a host label


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(event, f"{what}_us")() * 1000)


def _is_device(event) -> bool:
    return "CUDA" in str(event.device_type())


class Tracer:
    """Profiles the window when `enabled`; `summary()` afterwards. Off, it
    costs nothing and `summary()` is None."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.cuda = device is None or getattr(device, "type", device) == "cuda"
        self.prof = None
        self._mark = None
        self._summary: Optional[dict] = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()
        if self.cuda:
            torch.cuda.synchronize()

    def stop(self) -> None:
        """End the window: wait for the device, close the mark, stop."""
        if not self.enabled or self.prof is None:
            return
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self._summary = summarize(self.prof.profiler.kineto_results.events())
        self.prof = None

    def summary(self) -> Optional[dict]:
        return self._summary

    @contextlib.contextmanager
    def span(self, name: str):
        """A host annotation inside the trace (nothing when off)."""
        if self.prof is None:
            yield
            return
        from torch.profiler import record_function

        with record_function(name):
            yield


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of [start, end) rows."""
    if len(intervals) == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = np.append(ends[idx[1:] - 1], ends[-1])
    return np.stack([starts, stops], axis=1)


def _annotation(event) -> bool:
    fn = getattr(event, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def summarize(events) -> dict:
    """Reduce kineto events to the window's busy time, kernels and gaps.
    Annotations (`record_function` ranges, which the profiler also mirrors
    onto the device's timeline) are host events, never device work."""
    window: Optional[Tuple[int, int]] = None
    dev: List[Tuple[int, int]] = []
    dev_names: List[str] = []
    host: List[Tuple[int, int]] = []
    host_names: List[str] = []
    events = list(events)
    marks = {e.name() for e in events if _annotation(e)}
    for e in events:
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        name = e.name()
        if _is_device(e):
            if name not in marks and not _annotation(e):
                dev.append((start, end))
                dev_names.append(name)
        else:
            if name == WINDOW:
                window = (start, end)
            host.append((start, end))
            host_names.append(name)
    if window is None:
        raise RuntimeError("the trace holds no window mark")
    w0, w1 = window
    d = np.asarray(dev, np.int64).reshape(-1, 2)
    keep = (d[:, 1] > w0) & (d[:, 0] < w1)
    d = np.clip(d[keep], w0, w1)
    names = [n for n, k in zip(dev_names, keep) if k]
    busy = _merge(d)
    kernels: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for (s, t), n in zip(d, names):
        kernels[n] = kernels.get(n, 0.0) + (t - s) * 1e-9
        counts[n] = counts.get(n, 0) + 1
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9 if len(busy) else 0.0,
        "kernels": kernels,
        "counts": counts,
        "idle_gaps": _label_gaps(gaps, np.asarray(host, np.int64).reshape(-1, 2), host_names),
    }


def _label_gaps(gaps: np.ndarray, host: np.ndarray, names: List[str]) -> Dict[str, float]:
    """Idle seconds by the innermost host event that spans each gap's
    middle ("python" where none does), over the longest gaps."""
    out: Dict[str, float] = {}
    if len(gaps) == 0:
        return out
    length = gaps[:, 1] - gaps[:, 0]
    order = np.argsort(-length, kind="stable")[:LABELLED_GAPS]
    inner = np.array([n != WINDOW for n in names], bool)
    h, hn = host[inner], [n for n, k in zip(names, inner) if k]
    dur = h[:, 1] - h[:, 0] if len(h) else np.zeros(0, np.int64)
    for i in order:
        mid = (gaps[i, 0] + gaps[i, 1]) // 2
        hit = np.flatnonzero((h[:, 0] <= mid) & (h[:, 1] >= mid)) if len(h) else []
        label = hn[hit[np.argmin(dur[hit])]] if len(hit) else "python"
        out[label] = out.get(label, 0.0) + float(length[i]) * 1e-9
    return out


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the idle gaps by host activity, at most TOP each."""
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}
