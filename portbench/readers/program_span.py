"""Host ms in one of the program's spans (`dlsg.<name>`), as
`dlsg_tpu_torch.utils.profiler.span_totals()` holds them in the run's
process after the traced window (the program times its spans only while a
trace runs, on every thread): their summed seconds over the driver's
counter `per` (requests, steps), or over the span's own count when `per`
is None. None where the program keeps no such table or never entered the
span."""


def read(records, span, per=None):
    from dlsg_tpu_torch.utils import profiler

    table = getattr(profiler, "span_totals", None)
    t = table().get(span) if table is not None else None
    if not t:
        return None
    n = t["count"] if per is None else records["counters"].get(per)
    return 1e3 * t["seconds"] / n if n else None
