"""The 53 locations of a weekly hub submission (the US, 50 states, DC and
Puerto Rico) as NHSN-like weekly admissions series: each the weekly
generator's annual and half-yearly waves on a slow decline, shifted by its
own phase (up to 8 weeks either way) and with its own lognormal noise of
0.12, all drawn from ``rng``; scaled so that its noise-free peak is the
location's level.  Levels are 20,000 a week for the national series and
its share of that by the 2020 census for the others (from about 35 for
Wyoming up); values stay at least 1."""

from __future__ import annotations

import datetime as dt

import numpy as np

# 2020 census resident populations, thousands: AL .. WY, then PR
STATES = (5024, 733, 7152, 3012, 39538, 5774, 3606, 990, 690, 21538,
          10712, 1455, 1839, 12813, 6786, 3190, 2938, 4506, 4658, 1362,
          6177, 7030, 10077, 5706, 2961, 6154, 1084, 1962, 3105, 1378,
          9289, 2118, 20201, 10439, 779, 11799, 3959, 4237, 13003, 1097,
          5118, 887, 6911, 29146, 3272, 643, 8631, 7705, 1794, 5894, 577,
          3286)
NATIONAL = 20000.0
LEVELS = np.array([NATIONAL] + [NATIONAL * p / sum(STATES)
                                for p in STATES])


def generate(n: int, rng: np.random.Generator):
    """(dates, obs): ``n`` weeks from 2022-01-03, obs (53, n), the
    national series first."""
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)[None, :] + rng.uniform(-8, 8, size=(LEVELS.size, 1))
    shape = (0.15 * np.sin(2 * np.pi * t / 52)
             + 0.6 * np.sin(2 * np.pi * t / 26 + 1.0) - 0.004 * t)
    truth = LEVELS[:, None] * np.exp(shape - shape.max(1, keepdims=True))
    noise = np.exp(0.12 * rng.standard_normal(truth.shape))
    return dates, np.maximum(truth * noise, 1.0)
