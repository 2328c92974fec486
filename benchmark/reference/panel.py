"""The multi-series panel's semantics, frozen for the reference.

The panel's rules as the benchmark judges ``fit_panel``, on this
reference's own data rules (``data.py``), covariance (``heap.py``) and
LML (``gp.py``): each series' own normalisation, the shared proportion
grid, the masked LML of a series' first points in its own data order,
the sentinel-guarded reweight, and per-series ESS with systematic
resample indices.  The port's plain test reference
(``tests/plain_panel.py``) takes the grid, the reweight and the
resampling from here.

Where this departs from the reference Julia package: the Julia package
has no panel.  It fits series one at a time, each on its own schedule;
here every series is annealed on one grid of the longest series,
``ceil(f * n_s)`` points of series ``s`` at step ``f``.  The Julia package
works in float64 with no rejection sentinel, and leaves the resampling
rule to Gen's ``maybe_resample!``; this is the JAX package's systematic
rule.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import data, gp

SENTINEL = -1e10  # a rejected row's LML, and a broken reweight's delta


def capacity(lens) -> int:
    """The panel's one buffer width: the longest series rounded up to
    ``data.PAD``, at least 64."""
    return max(64, int(math.ceil(max(lens) / data.PAD)) * data.PAD)


def grid(n_max: int, proportion: float) -> list[int]:
    """The shared grid: the longest series' cumulative points a step."""
    return data.linear_schedule(n_max, max(proportion, 1.0 / n_max))


def grid_counts(n_k: int, n_max: int, lens) -> np.ndarray:
    """Points each series conditions on at the step that conditions
    ``n_k`` of the longest: ``ceil(n_k / n_max * n_s)``, at most n_s."""
    lens = np.asarray(lens, dtype=np.int64)
    return np.minimum(np.ceil(n_k / n_max * lens).astype(np.int64), lens)


def segments(n_max: int, proportion: float, lens):
    """[(capacity, [n_k, ...]), ...]: the grid's steps grouped by the
    buffer width that holds them."""
    return data.schedule_segments(grid(n_max, proportion), capacity(lens))


def masked_lml(types, params, log_noise, x, z, order, n: int):
    """LML (R,) of each row's tree at the series' first ``n`` points in
    its data order ``order``; ``SENTINEL`` where A is not positive
    definite.  ``x``, ``z``: the series' normalised inputs (time order),
    float64 tensors."""
    idx = torch.as_tensor(np.asarray(order)[:n], device=x.device)
    lml = gp.solve(types, params, log_noise, x[idx],
                   z[idx][:, None])["lml"][:, 0]
    return torch.where(torch.isfinite(lml), lml, SENTINEL)


def reweight(log_w, lml_old, lml_new) -> np.ndarray:
    """Log weights after a step: plus the LML's change, or ``SENTINEL``
    where either side is at or below -1e9."""
    old = np.asarray(lml_old, dtype=np.float64)
    new = np.asarray(lml_new, dtype=np.float64)
    broken = (old <= -1e9) | (new <= -1e9)
    return np.asarray(log_w, dtype=np.float64) + np.where(
        broken, SENTINEL, new - old)


def ess(log_w) -> float:
    w = np.exp(np.asarray(log_w, dtype=np.float64) - np.max(log_w))
    w = w / w.sum()
    return float(1.0 / np.sum(w * w))


def systematic(u: float, log_w) -> np.ndarray:
    """Systematic indices: positions ``(u + i) / P`` on the normalised
    weights' running sum."""
    w = np.exp(np.asarray(log_w, dtype=np.float64) - np.max(log_w))
    w = w / w.sum()
    P = w.shape[0]
    return np.searchsorted(np.cumsum(w), (u + np.arange(P)) / P).clip(
        0, P - 1)


def resample(rng: np.random.Generator, log_w, S: int, P: int,
             ess_fraction: float):
    """Per-series resampling of (S x P,) log weights: a series below
    ``ess_fraction`` x P of ESS draws one uniform (in series order) and
    takes its systematic indices, its weights reset to 0.  Returns (flat
    row indices, new log weights, the series resampled)."""
    log_w = np.array(log_w, dtype=np.float64)
    flat = np.arange(S * P)
    low = []
    for s in range(S):
        sl = slice(s * P, (s + 1) * P)
        if P > 1 and ess(log_w[sl]) < ess_fraction * P:
            flat[sl] = systematic(rng.uniform(), log_w[sl]) + s * P
            log_w[sl] = 0.0
            low.append(s)
    return flat, log_w, low
