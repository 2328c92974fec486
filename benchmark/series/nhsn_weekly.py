"""An NHSN-like weekly admissions series: an annual and a half-yearly
wave on a slow decline, with lognormal noise of 0.12 (the repository's
weekly bench series, its noise drawn from ``rng``)."""

from __future__ import annotations

import datetime as dt

import numpy as np


def generate(n: int, rng: np.random.Generator):
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)
    truth = 800 * np.exp(
        0.15 * np.sin(2 * np.pi * t / 52)
        + 0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
        - 0.004 * t
    )
    obs = np.maximum(truth * np.exp(0.12 * rng.standard_normal(n)), 1.0)
    return dates, obs
