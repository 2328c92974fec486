"""The host layer's data rules, frozen for the reference.

Box-Cox with its maximum-likelihood lambda and the fallback to a log when
the transform collapses, the zero offset rule, the time axis as days since
1970-01-01 normalised to [0, 1] over the training window, the standardised
targets, the data-annealing schedule and its capacity buckets.
"""

from __future__ import annotations

import datetime as dt

import numpy as np

PAD = 32  # capacity granule of the program's data buffers


def offset(values) -> float:
    """Half the smallest positive value where any value is 0, else 0."""
    values = np.asarray(values, dtype=np.float64)
    if values.min() == 0:
        pos = values[values > 0]
        return float(pos.min() / 2) if pos.size else 0.5
    return 0.0


def _boxcox(x, lam):
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if lam == 0.0:
            return np.log(x)
        return np.expm1(lam * np.log(x)) / lam


def boxcox_lambda(x) -> float:
    """Profile-likelihood maximum of the Box-Cox lambda: a coarse grid,
    then golden-section refinement."""
    x = np.asarray(x, dtype=np.float64)
    sum_logx = np.log(x).sum()
    n = x.size

    def negll(lam):
        z = _boxcox(x, lam)
        if not np.all(np.isfinite(z)):
            return np.inf
        with np.errstate(over="ignore"):
            var = z.var()
        if var <= 0 or not np.isfinite(var):
            return np.inf
        return 0.5 * n * np.log(var) - (lam - 1.0) * sum_logx

    grid = np.concatenate([np.linspace(-300.0, -5.0, 60),
                           np.linspace(-5.0, 5.0, 201),
                           np.linspace(5.0, 300.0, 60)])
    vals = np.array([negll(g) for g in grid])
    if not np.any(np.isfinite(vals)):
        return 1.0
    i = int(np.nanargmin(np.where(np.isfinite(vals), vals, np.inf)))
    a, b = float(grid[max(i - 1, 0)]), float(grid[min(i + 1, grid.size - 1)])
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = negll(c), negll(d)
    for _ in range(80):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = negll(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = negll(d)
        if abs(b - a) < 1e-10:
            break
    return float((a + b) / 2)


def boxcox_forward(values):
    """The forward transformation fitted to ``values``: Box-Cox, or a
    log where Box-Cox collapses the series' spread below a hundredth of
    its log range."""
    values = np.asarray(values, dtype=np.float64)
    off = offset(values)
    shifted = values + off
    lam = boxcox_lambda(shifted)
    z = _boxcox(shifted, lam)
    log_range = float(np.log(shifted).max() - np.log(shifted).min())
    if (not np.all(np.isfinite(z))
            or float(z.max() - z.min()) <= 1e-2 * log_range):
        return lambda y: np.log(np.asarray(y, dtype=np.float64) + off)
    return lambda y: _boxcox(np.asarray(y, dtype=np.float64) + off, lam)


def days(dates) -> np.ndarray:
    """Dates as float days since 1970-01-01."""
    epoch = dt.date(1970, 1, 1)
    return np.asarray([(d - epoch).days for d in dates], dtype=np.float64)


class Normaliser:
    """The training window's normalisation: time to [0, 1] over the
    window, targets to zero mean and unit (population) deviation."""

    def __init__(self, dates, y):
        t = days(dates)
        y = np.asarray(y, dtype=np.float64)
        self.t0 = float(t.min())
        span = float(t.max() - t.min())
        self.t_scale = span if span > 0 else 1.0
        self.y_mean = float(y.mean())
        std = float(y.std())
        self.y_std = std if std > 1e-12 else 1.0

    def x(self, dates) -> np.ndarray:
        return (days(dates) - self.t0) / self.t_scale

    def y(self, y) -> np.ndarray:
        return (np.asarray(y, dtype=np.float64) - self.y_mean) / self.y_std


def linear_schedule(n: int, proportion: float) -> list[int]:
    """Cumulative observation counts per SMC step, ending at ``n``; a step
    ingests at least one observation."""
    proportion = max(proportion, 1.0 / max(n, 1))
    step = max(1, int(round(proportion * n)))
    points = list(range(step, n + 1, step))
    if not points or points[-1] != n:
        points.append(n)
    return points


def capacity(n: int) -> int:
    """The smallest ``PAD`` multiple that holds n points."""
    return max(PAD, int(np.ceil(max(n, 1) / PAD)) * PAD)


def schedule_segments(schedule, cap_full):
    """[(capacity, [n_k, ...]), ...]: consecutive steps grouped by the
    capacity that holds them."""
    segments = []
    for n_k in schedule:
        cap = min(cap_full, capacity(n_k))
        if segments and segments[-1][0] == cap:
            segments[-1][1].append(int(n_k))
        else:
            segments.append((cap, [int(n_k)]))
    return segments
