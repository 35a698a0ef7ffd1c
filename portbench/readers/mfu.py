"""% of the card's peak (portbench/work.py) that the model FLOPs of the
work finished in a window make over the window's seconds: by default the
untraced window that a traced run measures before its traced one, since
the profiler slows the host."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import work  # noqa: E402


def read(records, flops="plain_model_flops", window="plain_window_s"):
    c = records["counters"]
    if not c.get(flops) or not c.get(window):
        return None
    return 100.0 * c[flops] / (c[window] * work.PEAK_FLOPS)
