"""Weighted interval score (WIS) — the CDC FluSight / COVID-19 Forecast Hub
standard scoring rule.

Port of the JAX package's ``eval/wis.py``, numpy only and carried over
whole, so scores are bitwise the JAX package's.  The reference scores its
vignette forecasts with a hand-rolled CRPS
(``docs/vignettes/getting-started.jl:689-728``); downstream
CDC surveillance pipelines that consume NowcastAutoGP-style forecasts score
quantile submissions with WIS (Bracher, Ray, Gneiting & Reich 2021,
"Evaluating epidemic forecasts in an interval format").  WIS is a weighted
sum of interval scores over a set of central prediction intervals plus the
absolute error of the median, and converges to CRPS as the quantile grid
densifies — so it slots next to :mod:`.crps` as the submission-format view
of the same forecast quality.

Everything here is host-side numpy on forecast *draws* (the framework's
native output), quantizing internally; the hot path (producing the draws)
stays on device.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "FLUSIGHT_QUANTILES",
    "interval_score",
    "wis_ensemble",
    "wis_matrix",
    "coverage_matrix",
]

#: The 23-point quantile grid used by CDC FluSight / the COVID-19 Forecast
#: Hub: the median plus 11 nested central intervals (98% … 10%).
FLUSIGHT_QUANTILES = np.array(
    [0.01, 0.025] + [round(0.05 * i, 2) for i in range(1, 20)] + [0.975, 0.99]
)


def interval_score(lower, upper, alpha: float, observation) -> np.ndarray:
    """Interval score of the central ``(1 - alpha)`` interval ``[lower, upper]``.

    ``IS_alpha(l, u; y) = (u - l) + 2/alpha (l - y) 1[y < l]
    + 2/alpha (y - u) 1[y > u]`` — width plus out-of-interval penalties.
    Broadcasts over array inputs.
    """
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    y = np.asarray(observation, dtype=np.float64)
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    width = upper - lower
    below = np.where(y < lower, (2.0 / alpha) * (lower - y), 0.0)
    above = np.where(y > upper, (2.0 / alpha) * (y - upper), 0.0)
    return width + below + above


def _interval_alphas(quantiles: np.ndarray) -> np.ndarray:
    """Alphas of the nested central intervals encoded by a symmetric
    quantile grid (every level q < 0.5 pairs with 1 - q)."""
    qs = np.sort(np.asarray(quantiles, dtype=np.float64))
    lower_qs = qs[qs < 0.5]
    for q in lower_qs:
        if not np.any(np.isclose(qs, 1.0 - q)):
            raise ValueError(
                f"quantile grid is not symmetric: {q} has no partner {1.0 - q}")
    return 2.0 * lower_qs  # central (1 - alpha) interval from (q, 1-q)


def wis_ensemble(draws, observation: float,
                 quantiles=FLUSIGHT_QUANTILES) -> float:
    """WIS of one predictive ensemble (1-D draws) against a scalar truth.

    Quantizes the draws at ``quantiles`` (a symmetric grid; median optional
    but conventional) and computes

    ``WIS = (|y - median|/2 + sum_k alpha_k/2 * IS_alpha_k) / (K + 1/2)``

    the Bracher et al. (2021) form with weights ``w_k = alpha_k / 2`` and
    ``w_0 = 1/2``.  With the FluSight grid this approximates CRPS closely
    (they coincide in the continuum limit), which
    the JAX package's ``tests/test_eval.py`` pins.
    """
    x = np.asarray(draws, dtype=np.float64).ravel()
    qs = np.sort(np.asarray(quantiles, dtype=np.float64))
    y = float(observation)
    alphas = _interval_alphas(qs)
    qvals = np.quantile(x, qs)

    has_median = bool(np.any(np.isclose(qs, 0.5)))
    median = qvals[np.argmin(np.abs(qs - 0.5))] if has_median \
        else float(np.quantile(x, 0.5))

    total = 0.5 * abs(y - median)
    for alpha in alphas:
        lo = qvals[np.argmin(np.abs(qs - alpha / 2.0))]
        hi = qvals[np.argmin(np.abs(qs - (1.0 - alpha / 2.0)))]
        total += (alpha / 2.0) * float(interval_score(lo, hi, alpha, y))
    return float(total / (len(alphas) + 0.5))


def wis_matrix(forecasts, observations,
               quantiles=FLUSIGHT_QUANTILES) -> np.ndarray:
    """Row-wise WIS of a ``(n_dates, n_draws)`` forecast matrix (the same
    shape contract as :func:`.crps.crps_matrix`)."""
    forecasts = np.asarray(forecasts, dtype=np.float64)
    observations = np.asarray(observations, dtype=np.float64)
    assert forecasts.shape[0] == observations.shape[0]
    return np.asarray(
        [wis_ensemble(forecasts[i], observations[i], quantiles)
         for i in range(forecasts.shape[0])]
    )


def coverage_matrix(forecasts, observations, levels=(0.5, 0.9)) -> dict:
    """Empirical central-interval coverage of a ``(n_dates, n_draws)``
    forecast matrix: fraction of rows whose truth lands inside each
    central ``level`` interval.  Returns ``{level: coverage}``."""
    forecasts = np.asarray(forecasts, dtype=np.float64)
    observations = np.asarray(observations, dtype=np.float64)
    assert forecasts.shape[0] == observations.shape[0]
    out = {}
    for level in levels:
        alpha = 1.0 - float(level)
        lo = np.quantile(forecasts, alpha / 2.0, axis=1)
        hi = np.quantile(forecasts, 1.0 - alpha / 2.0, axis=1)
        inside = (observations >= lo) & (observations <= hi)
        out[float(level)] = float(inside.mean())
    return out
