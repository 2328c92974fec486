"""Forecast sampling from a fitted GP particle ensemble.

Port of the JAX package's ``forecasting.py`` (the reference's plain
forecaster): draw joint samples from the particle-mixture predictive
posterior (``predict_mvn``, computed on the model's device) with the
model's numpy generator, then map back to the original scale with the
inverse transformation.  The per-draw HMC refresh (``forecast_n_hmc``) is
not ported yet.
"""

from __future__ import annotations

import numpy as np

from .models.gp_model import GPModel, predict_mvn
from .utils.apply import apply_elementwise

__all__ = ["forecast"]


def forecast(
    model: GPModel, forecast_dates, forecast_draws: int, *,
    inv_transformation=lambda y: y, forecast_n_hmc: int | None = None,
) -> np.ndarray:
    """Sample forecasts; returns ``(n_dates, forecast_draws)``.

    ``forecast_n_hmc=None`` draws all samples from the current model state
    (one predictive build, advancing ``model.rng``).  An ``int`` asks for
    HMC parameter steps before each draw, which raises
    ``NotImplementedError``: that path is ROADMAP.md's ``ops/forecast_scan.py``
    item, not ported yet.
    """
    if forecast_n_hmc is not None:
        raise NotImplementedError(
            "forecast_n_hmc (HMC refresh before each draw) is not ported yet "
            "(ROADMAP.md, modules to port: ops/forecast_scan.py)")
    dist = predict_mvn(model, list(forecast_dates))
    draws = dist.sample(model.rng, int(forecast_draws))
    return apply_elementwise(inv_transformation, draws)
