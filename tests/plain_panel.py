"""A plain float64 reference of the multi-series panel's semantics.

What ``parallel/panel.py::fit_panel`` promises, written out in plain
torch and numpy from its description, to hold the port against: each
series' own normalisation, the shared proportion grid, the masked LML of
a heap-encoded tree at a series' first points in its own data order (a
dense covariance and a float64 Cholesky), the sentinel-guarded reweight,
and per-series ESS with systematic resample indices.  It imports neither
JAX, nor the JAX package, nor any kernel of the port: the covariance is
the frozen plain interpreter of ``benchmark/reference/heap.py``.

The grid, the reweight and the resampling are the benchmark's frozen
copy (``benchmark/reference/panel.py``), imported here; this file adds
each series' normalisation from the description and a masked LML of its
own, from a dense covariance and a float64 Cholesky, independent of the
benchmark's ``gp.solve``.

Where this departs from the reference Julia package (NowcastAutoGP on
AutoGP.jl): the Julia package has no panel.  It fits series one at a
time (``docs/vignettes/getting-started.jl`` maps them serially), each on
its own schedule; here every series is annealed on one grid of the
longest series, ``ceil(f * n_s)`` points of series ``s`` at step ``f``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import heap
from benchmark.reference.panel import (  # noqa: F401  the shared semantics
    SENTINEL, grid, grid_counts, resample, reweight)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JITTER = 1e-5     # the model's diagonal jitter, part of its definition
LOG_2PI = math.log(2.0 * math.pi)


def normalise(days, y):
    """One series' inputs as the fit sees them: time to [0, 1] over the
    series' own span (a scale of 1 where the span is 0), targets to zero
    mean and unit population deviation (1 where it is 0).  Returns (x, z,
    (t0, t_scale, y_mean, y_std))."""
    t = np.asarray(days, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    t0 = float(t.min())
    t_scale = float(t.max() - t0) or 1.0
    y_mean = float(y.mean())
    y_std = float(y.std()) or 1.0
    return (t - t0) / t_scale, (y - y_mean) / y_std, (t0, t_scale, y_mean,
                                                      y_std)


def masked_lml(types, params, log_noise, x, z, order, n: int):
    """LML (R,) of each row's tree at the series' first ``n`` points in
    its data order ``order``; ``SENTINEL`` where A is not positive
    definite.  ``x``, ``z``: the series' normalised inputs in time
    order."""
    idx = torch.as_tensor(np.asarray(order)[:n])
    xs = torch.as_tensor(x, dtype=torch.float64)[idx]
    zs = torch.as_tensor(z, dtype=torch.float64)[idx]
    t = torch.as_tensor(types).long()
    p = torch.as_tensor(params, dtype=torch.float64)
    noise = torch.exp(torch.as_tensor(log_noise, dtype=torch.float64))
    A = heap.cov(t, p, xs, xs) + (noise + JITTER)[:, None, None] * torch.eye(
        n, dtype=torch.float64)
    L, info = torch.linalg.cholesky_ex(A)
    bad = info != 0
    L = torch.where(bad[:, None, None], torch.eye(n, dtype=torch.float64), L)
    rhs = zs.expand(t.shape[0], n)[:, :, None]
    alpha = torch.cholesky_solve(rhs, L)
    quad = (rhs * alpha).sum((1, 2))
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    lml = -0.5 * (quad + logdet + n * LOG_2PI)
    return torch.where(bad, SENTINEL, lml).numpy()

