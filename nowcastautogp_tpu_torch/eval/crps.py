"""Forecast evaluation: sample-based CRPS and quantile utilities.

Port of the JAX package's ``eval/crps.py``: the numpy estimators are
carried over as they are, and ``quantile_matrix_device`` aggregates on a
torch device.  The estimator is the
standard fair-ensemble form  ``CRPS(F, y) = E|X - y| - 0.5 E|X - X'|``
computed from forecast draws.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["crps_ensemble", "crps_matrix", "quantile_matrix",
           "quantile_matrix_device"]


def crps_ensemble(draws: np.ndarray, observation: float) -> float:
    """CRPS of one predictive ensemble (1-D draws) against a scalar truth."""
    x = np.asarray(draws, dtype=np.float64).ravel()
    term1 = np.abs(x - float(observation)).mean()
    # pairwise E|X - X'| over the n(n-1)/2 DISTINCT pairs (the fair-ensemble
    # form the reference vignette uses, ``getting-started.jl:697-698``),
    # via sorting: O(n log n) instead of O(n^2)
    xs = np.sort(x)
    n = xs.size
    if n < 2:
        return float(term1)
    coeffs = 2.0 * np.arange(1, n + 1) - n - 1
    term2 = 2.0 * np.sum(coeffs * xs) / (n * (n - 1))
    return float(term1 - 0.5 * term2)


def crps_matrix(forecasts: np.ndarray, observations: np.ndarray) -> np.ndarray:
    """Row-wise CRPS of a ``(n_dates, n_draws)`` forecast matrix."""
    forecasts = np.asarray(forecasts, dtype=np.float64)
    observations = np.asarray(observations, dtype=np.float64)
    assert forecasts.shape[0] == observations.shape[0]
    return np.asarray(
        [crps_ensemble(forecasts[i], observations[i])
         for i in range(forecasts.shape[0])]
    )


def quantile_matrix(forecasts: np.ndarray, qs) -> np.ndarray:
    """Per-row quantiles of a ``(n_dates, n_draws)`` forecast matrix ->
    ``(len(qs), n_dates)`` (the vignettes' per-row quantile summaries,
    ``docs/vignettes/getting-started.jl:432-436``)."""
    return np.quantile(np.asarray(forecasts, dtype=np.float64),
                       np.asarray(qs), axis=1)


def quantile_matrix_device(forecasts, qs, device="cuda") -> np.ndarray:
    """Per-row quantiles of a large ``(n_dates, n_draws)`` draw matrix,
    aggregated on ``device`` before any host transfer.  Matches
    ``np.quantile``'s default linear interpolation."""
    fc = torch.as_tensor(np.asarray(forecasts), dtype=torch.float32,
                         device=device)
    q = torch.as_tensor(np.asarray(qs, dtype=np.float32), device=device)
    return torch.quantile(fc, q, dim=1).cpu().numpy().astype(np.float64)
