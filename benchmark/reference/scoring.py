"""Scores of forecast draws: the log-scale CRPS and the distance of
probability-integral-transform values from uniform."""

from __future__ import annotations

import numpy as np


def crps(draws, truth) -> float:
    """Fair-ensemble CRPS of one row of draws against its truth."""
    x = np.sort(np.asarray(draws, dtype=np.float64).ravel())
    n = x.size
    t1 = np.abs(x - float(truth)).mean()
    if n < 2:
        return float(t1)
    coeffs = 2.0 * np.arange(1, n + 1) - n - 1
    return float(t1 - np.sum(coeffs * x) / (n * (n - 1)))


def log_crps(fc, truth) -> float:
    """Mean over horizons of the CRPS of log draws against the log truth."""
    fc = np.log(np.maximum(np.asarray(fc, dtype=np.float64), 1e-9))
    truth = np.log(np.asarray(truth, dtype=np.float64))
    return float(np.mean([crps(fc[i], truth[i]) for i in range(len(truth))]))


def ks_uniform(u) -> float:
    """Kolmogorov-Smirnov distance of the values ``u`` from U(0, 1)."""
    u = np.sort(np.asarray(u, dtype=np.float64).ravel())
    n = u.size
    i = np.arange(1, n + 1)
    return float(max(np.max(i / n - u), np.max(u - (i - 1) / n)))
