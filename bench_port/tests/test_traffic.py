"""The open-loop schedule from a seed, and the percentiles of a run."""

import math

import numpy as np
import pytest

from bench_port.harness.kinds.serve import schedule
from bench_port.harness.stats import percentile


def test_schedule_is_fixed_by_the_seed_and_shares_its_gaps():
    a, b = schedule(2**31 + 7, 5.0, 40.0), schedule(2**31 + 7, 5.0, 40.0)
    c = schedule(12, 5.0, 40.0)
    assert len(a) == 200 and a[0] == 0.0
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # the same set of gaps in another order, mean 1/rate
    ga, gc = np.diff(a), np.diff(c)
    assert np.all(ga > 0)
    full = -np.log1p(-(np.arange(200) + 0.5) / 200) / 5.0
    assert abs(full.mean() - 0.2) < 0.01
    assert np.isin(np.round(ga, 12), np.round(full, 12)).all()
    assert np.isin(np.round(gc, 12), np.round(full, 12)).all()


def test_percentiles_count_every_request_and_failures_as_misses():
    lat = np.arange(1, 101, dtype=float)        # 1..100
    assert percentile(lat, 50) == 50 and percentile(lat, 95) == 95
    failed = lat.copy()
    failed[[3, 10, 20, 30, 40, 50]] = math.inf  # 6 failures of 100
    # a failure lies above every limit: the 95th is now infinite
    assert math.isinf(percentile(failed, 95))
    assert percentile(failed, 50) == 56
    assert percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        percentile([], 50)
