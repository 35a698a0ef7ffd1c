"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run builds the cell's model from the seed
on the card, warms the cell's own shapes, measures for `--seconds`, checks
what the timed path produced against the plain reference, and prints one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each compared number
beside its limit. Progress goes to standard error. Without a card, or
with fewer cards than the cell asks for, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        print("portbench: --seed must be a whole number >= 0", file=sys.stderr)
        return 2
    spec = harness.benchmark()
    cell = harness.cell_of(spec, args.workload)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = harness.Run(args, spec, cell, T0)
    driver = harness.load_module("drivers", run.traffic["driver"])
    out = driver.run(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if args.trace:
        if out.trace is None or out.trace["busy_s"] <= 0:
            print("portbench: the traced window shows no device work", file=sys.stderr)
            return 5
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
    line, check_lines = harness.result_line(run, out, device)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for s in check_lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
