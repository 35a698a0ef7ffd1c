"""A traced run of one cell that also writes its host annotations' table.

    python3 portbench/phases.py <out.json> --workload <name> --seed <n> --seconds <s> --trace 1

Runs `portbench/run.py` with the arguments after `<out.json>` and prints its
result line. When the traced window is reduced, it also writes `<out.json>`:
for each host annotation in the window but the window mark (the program's
`dlsg.*` spans, the drivers' `portbench.*`), its `count`, its `seconds`
clipped to the window, its `idle_s` (the part of those seconds with no merged
device interval) and `idle_share` (%). The per-layer metrics do not read it.
"""

from __future__ import annotations

import json
import runpy
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402


def annotations(events) -> dict:
    """The table of the module doc, from kineto events."""
    marks = {e.name() for e in events if trace._annotation(e)}
    window, dev, ann = None, [], {}
    for e in events:
        start = trace._ns(e, "start")
        end = start + trace._ns(e, "duration")
        name = e.name()
        if trace._is_device(e):
            if name not in marks and not trace._annotation(e):
                dev.append((start, end))
        elif name == trace.WINDOW:
            window = (start, end)
        elif trace._annotation(e):
            ann.setdefault(name, []).append((start, end))
    w0, w1 = window
    d = np.asarray(dev, np.int64).reshape(-1, 2)
    busy = trace._merge(np.clip(d[(d[:, 1] > w0) & (d[:, 0] < w1)], w0, w1))
    out = {}
    for name, iv in ann.items():
        iv = np.clip(np.asarray(iv, np.int64), w0, w1)
        iv = iv[iv[:, 1] > iv[:, 0]]
        if not len(iv):
            continue
        total = int((iv[:, 1] - iv[:, 0]).sum())
        covered = 0
        for s, t in iv:
            b = np.clip(busy, s, t)
            covered += int((b[:, 1] - b[:, 0]).sum()) if len(b) else 0
        out[name] = {"count": len(iv), "seconds": total * 1e-9, "idle_s": (total - covered) * 1e-9,
                     "idle_share": 100.0 * (total - covered) / total}
    return out


def main() -> None:
    out_path = sys.argv[1]
    summarize = trace.summarize

    def summarize_and_write(events):
        events = list(events)
        with open(out_path, "w") as f:
            json.dump(annotations(events), f, indent=1)
        return summarize(events)

    trace.summarize = summarize_and_write
    sys.argv = [str(ROOT / "portbench" / "run.py")] + sys.argv[2:]
    runpy.run_path(sys.argv[0], run_name="__main__")


if __name__ == "__main__":
    main()
