"""The output check's arithmetic: the numbers compared with their limits,
and the verdict."""

from __future__ import annotations

import math

import numpy as np


def worst_rel_l2(out, ref) -> float:
    """The largest relative L2 gap ||out - ref|| / ||ref|| over the maps
    of [..., H, W, C] arrays (one map per leading index): NaN where
    `out` is not finite."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        raise ValueError(f"output {out.shape} and reference {ref.shape}")
    if not np.isfinite(out).all():
        return math.nan
    axes = tuple(range(out.ndim - 3, out.ndim))
    num = np.sqrt(((out - ref) ** 2).sum(axis=axes))
    den = np.maximum(np.sqrt((ref ** 2).sum(axis=axes)), 1e-12)
    return float((num / den).max())


def verdict(checks: dict) -> bool:
    """True when every compared number is finite and at most its limit.
    checks: {name: (value, limit)}."""
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())
