"""% of the traced window in which no kernel or copy ran on the device."""


def read(records):
    t = records.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
