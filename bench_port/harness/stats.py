"""Order statistics of a run's requests."""

from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all `values` (the smallest
    value with at least q% of them at or below it). A failed request is
    an infinite value, so it counts as missing every limit."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * v.size))
    return float(v[rank - 1])
