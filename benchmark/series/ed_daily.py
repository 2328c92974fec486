"""A daily emergency-department visit series: a yearly wave of random
phase, a weekday reporting effect, a random trend and lognormal noise of
0.08 (the repository's daily-cadence series)."""

from __future__ import annotations

import datetime as dt

import numpy as np


def generate(n: int, rng: np.random.Generator):
    t = np.arange(n)
    season = 0.6 * np.sin(2 * np.pi * t / 365.0 + rng.uniform(0, 2 * np.pi))
    weekday = np.array([0.05, 0.12, 0.10, 0.06, 0.0, -0.25, -0.35])
    dow = weekday[t % 7] * rng.uniform(0.8, 1.2)
    trend = rng.uniform(0.0006, 0.0018) * t
    truth = 140 * np.exp(season + dow + trend)
    obs = np.maximum(truth * np.exp(0.08 * rng.standard_normal(n)), 1.0)
    dates = [dt.date(2024, 1, 1) + dt.timedelta(days=int(i)) for i in t]
    return dates, obs
