"""Order statistics the metrics share."""

from __future__ import annotations

import math

import numpy as np


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of all values do not exceed (an infinite value, a failed
    request, counts as over any limit)."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])
