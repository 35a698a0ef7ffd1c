"""The ratio of two of the program's counters, times `scale`: what
`dlsg_tpu_torch.utils.profiler.counters()` holds in the run's process after
the traced window (the program counts only while a trace runs). None where
the program keeps no such table, or `den` is missing or 0, or `num` missing."""


def read(records, num, den, scale=100.0):
    from dlsg_tpu_torch.utils import profiler

    table = getattr(profiler, "counters", None)
    c = table() if table is not None else {}
    if not c.get(den) or num not in c:
        return None
    return scale * float(c[num]) / float(c[den])
