"""Learning-rate schedule IterExponential. Counterpart of
`stablemtl_tpu/utils/schedules.py`: linear warmup to 1.0, then exponential
decay reaching `final_ratio` at `total_iter_length`, flat afterwards."""

from __future__ import annotations

import math


def iter_exponential_ratio(n_iter, total_iter_length: int, final_ratio: float,
                           warmup_steps: int = 0) -> float:
    """The learning-rate multiplier at step `n_iter`."""
    n = float(n_iter)
    if n < warmup_steps:
        return n / warmup_steps
    if n >= total_iter_length:
        return final_ratio
    return math.exp((n - warmup_steps) / (total_iter_length - warmup_steps)
                    * math.log(final_ratio))


class IterExponential:
    """Callable form: IterExponential(total, final_ratio, warmup)(n)."""

    def __init__(self, total_iter_length: int, final_ratio: float,
                 warmup_steps: int = 0):
        self.total_iter_length = total_iter_length
        self.final_ratio = final_ratio
        self.warmup_steps = warmup_steps

    def __call__(self, n_iter) -> float:
        return iter_exponential_ratio(n_iter, self.total_iter_length,
                                      self.final_ratio, self.warmup_steps)
