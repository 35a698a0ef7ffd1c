"""A statistic (`mean`, or `pN` for a percentile) of a benchmark-side span,
times `scale`."""

import numpy as np


def read(records, span, stat="mean", scale=1.0):
    v = records.get("spans", {}).get(span)
    if not v:
        return None
    v = np.asarray(v, float)
    x = v.mean() if stat == "mean" else np.percentile(v, float(stat[1:]))
    return float(x) * scale
