"""Surface-normal metric (parity with reference src/util/metric_normal.py).

Copy of `stablemtl_tpu/utils/metrics/normal.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _l2_normalize(x: np.ndarray, axis: int, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, eps)


def mean_angular_error(output, target, valid_mask=None):
    """Mean angular error in degrees over valid pixels; inputs [B,3,H,W]."""
    output = np.asarray(output, np.float64)
    target = np.asarray(target, np.float64)
    assert output.shape == target.shape and output.shape[1] == 3 and output.ndim == 4

    o = _l2_normalize(output, axis=1)
    t = _l2_normalize(target, axis=1)
    cos = np.clip((o * t).sum(axis=1, keepdims=True), -1.0, 1.0)
    err = np.arccos(cos) * 180.0 / np.pi

    if valid_mask is None:  # advertised default: all pixels valid
        valid_mask = np.ones_like(err)
    err = err * valid_mask
    n = valid_mask.sum((-1, -2))
    return float((err.sum((-1, -2)) / n).mean())
