"""Statistics of a run: nearest-rank percentiles over every sample, and the
spread the bounds are set from."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values`` (no sample left
    out, none interpolated)."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
