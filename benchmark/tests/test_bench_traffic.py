"""The open-loop schedule and the tail arithmetic."""

import math

import numpy as np
import pytest

from benchmark.drivers import loadgen
from benchmark.stats import p95


def test_arrivals_fill_the_window_at_the_rate():
    due = loadgen.arrivals(np.random.default_rng(3), 60.0, 20.0)
    assert len(due) == 1200
    assert due[0] == 0.0 and due.max() < 20.0
    assert np.all(np.diff(due) > 0)
    gaps = np.diff(np.append(due, 20.0))
    assert gaps.mean() == pytest.approx(1 / 60.0)
    # exponential: the gaps' spread equals their mean
    assert gaps.std() == pytest.approx(gaps.mean(), rel=0.05)


def test_every_seed_offers_the_same_arrivals_in_another_order():
    a = loadgen.arrivals(np.random.default_rng(1), 50.0, 10.0)
    b = loadgen.arrivals(np.random.default_rng(2 ** 31 + 7), 50.0, 10.0)
    assert not np.allclose(a, b)
    np.testing.assert_allclose(np.sort(np.diff(np.append(a, 10.0))),
                               np.sort(np.diff(np.append(b, 10.0))))


def test_sizes_are_balanced():
    s = loadgen.sizes(np.random.default_rng(5), 1000, 1, 4)
    assert sorted(set(s)) == [1, 2, 3, 4]
    assert [int((s == k).sum()) for k in (1, 2, 3, 4)] == [250, 250, 250, 250]


def test_p95_is_the_nearest_rank_over_all_requests():
    assert p95(range(1, 101)) == 95.0
    assert p95([5.0]) == 5.0
    assert p95(list(range(1, 20)) + [1000.0]) == 19.0  # 19 of 20 do not exceed 19
    # a failed request counts as over any limit
    lat = [0.01] * 94 + [math.inf] * 6
    assert p95(lat) == math.inf
    assert p95([0.01] * 95 + [math.inf] * 5) == 0.01
