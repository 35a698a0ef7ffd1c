"""% of a kernel function's bound (portbench/work.py) over its device time
in the traced window: the least time the card could take for the calls
the program made, over the time they took.

`calls` names the one launch a call makes (K1's `vh_wgmma_kernel`, K2's
`lstm_scan_kernel`); `time` every launch that belongs to the function
(K1's merge and its TF32 split too). `kernel` picks the arithmetic: `k1`,
a decode's first step on `rows` hypotheses and each later one on
rows x beam; `k2`, each call one direction over `rows` clips.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import work  # noqa: E402


def read(records, kernel, calls, time):
    t, d = records.get("trace"), records.get("decodes")
    if not t or not d:
        return None
    launches = sum(n for k, n in t["counts"].items() if calls in k)
    device_s = sum(s for k, s in t["kernels"].items() if any(m in k for m in time))
    if not launches or device_s <= 0:
        return None
    if kernel == "k1":
        first = min(d["count"], launches)
        one = work.k1(d["rows"], d["H"], d["V"], d["beam"], d["w_bytes"]).bound_s()
        later = work.k1(d["rows"] * d["beam"], d["H"], d["V"], d["beam"], d["w_bytes"]).bound_s()
        bound = first * one + (launches - first) * later
    elif kernel == "k2":
        bound = launches * work.k2(d["rows"], d["T"], d["lstm_H"]).bound_s()
    else:
        raise ValueError(f"no arithmetic for kernel {kernel!r}")
    return 100.0 * bound / device_s
