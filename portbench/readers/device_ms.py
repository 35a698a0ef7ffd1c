"""Device ms of the operations whose names hold any of `match`, per unit of
the counter `per` (requests, steps)."""


def read(records, match, per):
    t = records.get("trace")
    n = records["counters"].get(per)
    if not t or not n:
        return None
    names = [k for k in t["kernels"] if any(m in k for m in match)]
    if not names:
        return None
    return sum(t["kernels"][k] for k in names) * 1e3 / n
