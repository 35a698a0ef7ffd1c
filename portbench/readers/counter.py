"""A counter of the run as it stands, times `scale`."""


def read(records, key, scale=1.0):
    v = records["counters"].get(key)
    return None if v is None else float(v) * scale
