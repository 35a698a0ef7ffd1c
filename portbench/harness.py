"""What every run shares: the cell's files, the program's configuration, the
result line and the checks around it.

A cell (`workloads` in BENCHMARK.json) names a configuration,
`portbench/configs/<config>.json`, and a traffic mix,
`portbench/traffic/<traffic>.json`, whose `driver` names the module
`portbench/drivers/<driver>.py` that runs it. A per-layer metric is
`portbench/metrics/<name>.json`: the reader `portbench/readers/<reader>.py`
and its arguments. All of them are found by name, so a new cell, mix or
metric is new files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dlsg_tpu")
TRACE_SECONDS = 10.0


def load_json(*parts: str) -> Any:
    with open(BENCH.joinpath(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """`portbench/<kind>/<name>.py`, loaded by path."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, kind: str, cell: str) -> List[dict]:
    """The `end_to_end` or `per_layer` entries that this cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    no library pulled into loading JAX on its own."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the cell's end-to-end values, the records its
    per-layer readers take, the checks and the device reading."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    records: Dict[str, Any]
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[dict] = None


class Run:
    """The arguments, the cell's files and the clock of one run."""

    def __init__(self, args, spec: dict, cell: dict, t0: float, device=None,
                 config: Optional[dict] = None, traffic: Optional[dict] = None):
        import torch

        self.args, self.spec, self.cell, self.t0 = args, spec, cell, t0
        self.device = torch.device("cuda", 0) if device is None else torch.device(device)
        self.config = config or load_json("configs", f"{cell['config']}.json")
        self.traffic = traffic or load_json("traffic", f"{cell['traffic']}.json")
        self.setup_s: Optional[float] = None

    @property
    def seed(self) -> int:
        return self.args.seed

    def model_dict(self, role: str) -> dict:
        """The configuration as run for `role` (serving or training)."""
        return {**self.config["model"], **self.config[role]}

    def program_config(self, role: str):
        """The program's DLSGConfig for `role`."""
        from dlsg_tpu_torch.config import DLSGConfig

        known = {f.name for f in dataclasses.fields(DLSGConfig)}
        d = {k: tuple(v) if isinstance(v, list) else v
             for k, v in self.model_dict(role).items() if k in known}
        return DLSGConfig(**d)

    def window_seconds(self) -> float:
        """How long the window lasts: `--seconds`, and at most TRACE_SECONDS
        under `--trace 1`, whose profiler slows the host and whose trace
        takes time to read."""
        return min(self.args.seconds, TRACE_SECONDS) if self.args.trace else self.args.seconds

    def window_started(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def log(self, msg: str) -> None:
        print(f"[portbench {time.perf_counter() - self.t0:8.2f}s] {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, reset: bool = False) -> int:
    """The device's peak of allocated memory so far (0 off a card); with
    `reset`, a new peak starts."""
    import torch

    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return int(peak)


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, float), q))


def quarters(ends, t0: float) -> List[float]:
    """The mean seconds of a window's iterations, given their end times and
    the window's start `t0`, over each quarter of them in turn: how the
    pace moved through a run."""
    import numpy as np

    e = np.asarray(ends, float)
    if len(e) < 8:
        return []
    d = np.diff(np.concatenate([[t0], e]))
    return [round(float(q.mean()), 5) for q in np.array_split(d, 4)]


def result_line(run: Run, out: Outcome, device: dict) -> Tuple[dict, List[str]]:
    """The last line's object and the stderr lines of the checks."""
    spec, cell, trace = run.spec, run.cell["name"], run.args.trace
    metrics: Dict[str, dict] = {}
    if trace:
        records = {**out.records, "trace": out.trace}
        for m in metrics_of(spec, "per_layer", cell):
            entry = load_json("metrics", f"{m['name']}.json")
            value = load_module("readers", entry["reader"]).read(records, **entry.get("args", {}))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out.e2e, "setup_s": run.setup_s}
        for m in metrics_of(spec, "end_to_end", cell):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    correct = out.failed == 0 and all(c.ok() for c in out.checks)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        from portbench.trace import breakdown

        line["breakdown"] = breakdown(out.trace)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    lines = [f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok() else 'FAIL'}"
             for c in out.checks]
    lines.append(f"failed requests: {out.failed} of {out.attempted} (limit 0)")
    return line, lines
