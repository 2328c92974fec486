"""Synthetic series families for benchmarking and statistical studies.

The port's own copy of the JAX package's ``eval/families.py`` (numpy only,
so the draws are bitwise the JAX package's for the same seed):

* :func:`nhsn_like` -- the bench's log-sinusoid seasonal family, the
  closest analog to weekly NHSN counts;
* :func:`seir_wave` -- stochastic SEIR epidemic waves with a seasonally
  forced, drifting contact rate;
* :func:`outbreak_cp` -- piecewise log-linear outbreak/decay regimes with a
  hard reporting-system changepoint and heavy-tailed noise (the second
  family ``bench_torch.py`` gates).
"""

from __future__ import annotations

import numpy as np

__all__ = ["nhsn_like", "seir_wave", "outbreak_cp", "FAMILIES"]


def nhsn_like(n, seed):
    """The bench's family."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    truth = 800 * np.exp(
        0.15 * np.sin(2 * np.pi * t / 52)
        + 0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
        - 0.004 * t
    )
    return np.maximum(truth * np.exp(0.12 * rng.standard_normal(n)), 1.0)


def seir_wave(n, seed):
    """Weekly hospitalization-like counts from a stochastic SEIR with a
    seasonally forced, drifting contact rate."""
    rng = np.random.default_rng(seed + 7_000)
    days = n * 7
    N_pop = 1e7
    beta0 = 0.33 * np.exp(0.25 * rng.standard_normal())
    seas_amp = 0.35 + 0.1 * rng.random()
    phase = rng.uniform(0, 2 * np.pi)
    sigma, gamma = 1 / 3.0, 1 / 5.0
    ihr = 0.012 * np.exp(0.3 * rng.standard_normal())
    S, E, I = N_pop - 2000.0, 1000.0, 1000.0
    drift = 0.0
    weekly = []
    acc = 0.0
    for d in range(days):
        drift += 0.012 * rng.standard_normal()
        drift *= 0.995
        beta = beta0 * np.exp(
            seas_amp * np.sin(2 * np.pi * d / 365 + phase) + drift)
        new_inf = beta * S * I / N_pop
        new_sym = sigma * E
        S -= new_inf
        E += new_inf - new_sym
        I += new_sym - gamma * I
        # waning immunity keeps multiple waves alive
        S += 0.004 * (N_pop - S - E - I) / 1.0
        acc += ihr * new_sym
        if (d + 1) % 7 == 0:
            weekly.append(acc)
            acc = 0.0
    obs = np.asarray(weekly[:n])
    obs = obs * np.exp(0.08 * rng.standard_normal(n))
    return np.maximum(obs, 1.0)


def outbreak_cp(n, seed):
    """Outbreak and decay with hard changepoints and irregular noise:
    piecewise log-linear regimes, a jump discontinuity (reporting-system
    change), heavy-tailed multiplicative noise and occasional
    under-reported weeks."""
    rng = np.random.default_rng(seed + 40_000)
    t = np.arange(n)
    # endemic baseline with a slow random drift slope
    base = 120.0 * np.exp(0.002 * rng.normal(1.0, 0.3) * t)
    # outbreak onset in the middle third: fast growth, slower decay
    t_on = int(rng.integers(n // 3, 2 * n // 3))
    dur_up = int(rng.integers(6, 14))
    growth = rng.uniform(0.25, 0.45)
    decay = rng.uniform(0.06, 0.16)
    ramp = np.where(
        t < t_on, 0.0,
        np.where(t < t_on + dur_up, growth * (t - t_on),
                 growth * dur_up - decay * (t - t_on - dur_up)))
    truth = base * np.exp(np.maximum(ramp, 0.0))
    # reporting-system changepoint: abrupt persistent level shift
    t_cp = int(rng.integers(n // 6, n - n // 6))
    truth = truth * np.where(
        t >= t_cp, np.exp(rng.choice([-1, 1]) * rng.uniform(0.25, 0.5)), 1.0)
    # irregular noise: student-t multiplicative + rare dropout weeks
    obs = truth * np.exp(np.clip(0.1 * rng.standard_t(3, size=n), -1.0, 1.0))
    drop = rng.random(n) < 0.03
    obs[drop] *= rng.uniform(0.3, 0.6, size=int(drop.sum()))
    return np.maximum(obs, 1.0)


FAMILIES = {"nhsn_like": nhsn_like, "seir_wave": seir_wave,
            "outbreak_cp": outbreak_cp}
