"""Model fitting: flat-series guard + SMC fit wrapper.

Port of the JAX package's ``fitting.py``: guard degenerate (near-constant)
transformed series with Gaussian jitter so the GP covariance stays
positive-definite (issue #51), build the SMC data-ingestion schedule, and
run the data-annealed SMC engine on the requested device.
"""

from __future__ import annotations

import warnings

import numpy as np

from .inference.schedule import linear_schedule
from .inference.smc import fit_smc
from .models.config import GPConfig
from .models.gp_model import GPModel
from .tdata import TData
from .utils.profiling import span

__all__ = ["make_and_fit_model", "_stabilize_for_fit"]


def _stabilize_for_fit(y, *, flat_threshold: float = 1e-3,
                       rng: np.random.Generator | None = None):
    """Add tiny Gaussian jitter to a near-constant series; otherwise return
    the input *unchanged* (identity, so callers can check ``is``).

    With relative range ``(max - min) / (|mean| + 1)`` below
    ``flat_threshold`` the standardized covariance would be singular, so
    jitter with ``sigma = flat_threshold * scale`` makes the series fittable.
    """
    y_arr = np.asarray(y)
    n = y_arr.shape[0]
    if n <= 1:
        return y
    scale = abs(float(y_arr.sum()) / n) + 1.0
    rel_range = float(y_arr.max() - y_arr.min()) / scale
    if rel_range >= flat_threshold:
        return y  # enough spread -> untouched (identity contract)
    sigma = flat_threshold * scale
    warnings.warn(
        f"Near-constant series (relative range {rel_range} < {flat_threshold}); "
        f"adding jitter (sigma = {sigma}) so the GP covariance stays "
        "positive-definite (issue #51).",
        stacklevel=2,
    )
    rng = rng or np.random.default_rng()
    return y_arr + sigma * rng.standard_normal(n)


def make_and_fit_model(
    data: TData, *, n_particles: int = 1, smc_data_proportion: float = 0.1,
    flat_threshold: float = 1e-3, config: GPConfig | None = None,
    seed: int | None = None, device="cuda", **kwargs,
) -> GPModel:
    """Create and fit a GP particle ensemble via SMC on ``device``.

    ``smc_data_proportion`` is clamped so every schedule step ingests at least
    one observation; ``n_mcmc``/``n_hmc`` are required pass-through kwargs of
    the SMC engine; other engine options (``hmc_config``, ``biased``,
    ``shuffle``, ``verbose``, ``adaptive_rejuvenation``) pass through
    unchanged.  The ``config`` object is stored on the model by reference.
    """
    with span("api/make_and_fit_model"):
        config = config if config is not None else GPConfig()
        n_train = len(data.y)
        y_fit = _stabilize_for_fit(data.y, flat_threshold=flat_threshold)
        model = GPModel(data.ds, y_fit, n_particles=n_particles,
                        config=config, seed=seed, device=device)
        effective_proportion = max(smc_data_proportion, 1.0 / max(n_train, 1))
        schedule = linear_schedule(n_train, effective_proportion)
        fit_smc(model, schedule=schedule, **kwargs)
        return model
