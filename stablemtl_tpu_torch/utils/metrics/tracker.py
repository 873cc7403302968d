"""Running-average metric tracker (parity with reference metric.py:10-30).

Copy of `stablemtl_tpu/utils/metrics/tracker.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations


class MetricTracker:
    def __init__(self, *keys):
        self._keys = list(keys)
        self.reset()

    def reset(self):
        self._total = {k: 0.0 for k in self._keys}
        self._counts = {k: 0 for k in self._keys}

    def update(self, key: str, value: float, n: int = 1):
        if key not in self._total:
            self._keys.append(key)
            self._total[key] = 0.0
            self._counts[key] = 0
        self._total[key] += float(value) * n
        self._counts[key] += n

    def avg(self, key: str) -> float:
        c = self._counts[key]
        return self._total[key] / c if c else 0.0

    def result(self) -> dict:
        return {k: self.avg(k) for k in self._keys}
