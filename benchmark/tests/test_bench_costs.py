"""The frozen work count: the program's arithmetic at capacities up to
512, one formula above, and the call counts of the algorithm."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import costs
from benchmark.reference import data


def _prior_trees(P=64, seed=0):
    from nowcastautogp_tpu_torch.models.config import GPConfig
    from nowcastautogp_tpu_torch.models.structures import sample_particle

    rng = np.random.default_rng(seed)
    cfg = GPConfig(max_depth=5)
    return np.stack([sample_particle(rng, cfg)[0] for _ in range(P)])


@pytest.mark.parametrize("n", [32, 96, 160, 512])
def test_call_cost_equals_program_arithmetic_up_to_512(n):
    from nowcastautogp_tpu_torch.utils import flops

    t = _prior_trees()
    want = flops.kernel_costs(t, n)
    assert costs.call_cost(t, n, grad=False) == want["K2"]
    assert costs.call_cost(t, n, grad=True) == want["K1"]


def test_one_formula_above_512():
    """Above 512 the count is the fused formula's, not the composed
    core's own inverse: the same algorithm whatever implements it."""
    t = _prior_trees()
    for grad in (False, True):
        b1, o1 = costs.call_cost(t, 512, grad)
        b2, o2 = costs.call_cost(t, 576, grad)
        cube = (576 / 512) ** 3
        assert o1 * cube * 0.95 < o2 < o1 * cube * 1.05
        assert b2 > b1


def test_weekly_fit_counts():
    calls = costs.fit_calls(150, 0.1, 14, 5, 5)
    assert sum(c[1] for c in calls) == 150
    assert sum(c[2] for c in calls) == 3640
    assert [c[0] for c in calls] == [32, 64, 96, 128, 160]


def test_daily_fit_counts_follow_schedule_segments():
    from nowcastautogp_tpu_torch.inference.schedule import linear_schedule
    from nowcastautogp_tpu_torch.inference.smc import schedule_segments

    calls = costs.fit_calls(560, 0.125, 8, 5, 5)
    segs = schedule_segments(linear_schedule(560, 0.125), 576)
    assert [(cap, len(s) * 9, len(s) * 8 * 26) for cap, s in segs] == calls
    assert sum(c[1] for c in calls) == 72
    assert sum(c[2] for c in calls) == 1664
    assert calls[-1][0] == 576


def test_refresh_counts():
    assert costs.refresh_calls(152, 1, 5, 160) == [(160, 2, 6)]


def test_work_reads_only_trees_and_calls():
    t = _prior_trees(P=200, seed=3)
    calls = costs.fit_calls(150, 0.1, 14, 5, 5)
    w = costs.work(t, calls)
    assert w == costs.work(t.copy(), list(calls))
    want = sum(nv * costs.call_cost(t, cap, False)[1]
               + ng * costs.call_cost(t, cap, True)[1]
               for cap, nv, ng in calls)
    assert w["ops"] == pytest.approx(want, rel=1e-12)
    assert 0 < w["least_s"] < w["ops"]
    assert data.capacity(150) == 160
