"""Forecast sampling from a fitted GP particle ensemble.

Port of the JAX package's ``forecasting.py`` (the reference's plain
forecaster): draw joint samples from the particle-mixture predictive
posterior (``predict_mvn``, computed on the model's device) with the
model's numpy generator, or, with ``forecast_n_hmc``, refresh the
hyperparameters with that many HMC steps before each draw
(``ops/forecast_scan.py``, on the model's device and its torch generator),
then map back to the original scale with the inverse transformation.
"""

from __future__ import annotations

import numpy as np

from .models.config import HMCConfig
from .models.gp_model import GPModel, predict_mvn
from .models.structures import prior_arrays
from .ops.forecast_scan import forecast_hmc_scan
from .ops.lml import DEFAULT_JITTER
from .utils.apply import apply_elementwise

__all__ = ["forecast"]


def forecast(
    model: GPModel, forecast_dates, forecast_draws: int, *,
    inv_transformation=lambda y: y, forecast_n_hmc: int | None = None,
) -> np.ndarray:
    """Sample forecasts; returns ``(n_dates, forecast_draws)``.

    ``forecast_n_hmc=None`` draws all samples from the current model state
    (one predictive build, advancing ``model.rng``); an ``int`` runs that
    many HMC parameter steps before *each* draw, mutating the model's
    hyperparameters between draws -- both the dispatch semantics of the
    reference.
    """
    dates = list(forecast_dates)
    if forecast_n_hmc is None:
        dist = predict_mvn(model, dates)
        draws = dist.sample(model.rng, int(forecast_draws))
    else:
        if int(forecast_n_hmc) <= 0:
            raise ValueError("forecast_n_hmc must be > 0 if specified")
        draws = _forecast_hmc(model, dates, int(forecast_draws),
                              int(forecast_n_hmc))
    return apply_elementwise(inv_transformation, draws)


def _forecast_hmc(model: GPModel, dates, n_draws: int,
                  n_hmc: int) -> np.ndarray:
    """The HMC-refresh draw loop over the full data buffer; writes the
    refreshed hyperparameters, cached LML and step scales back to
    ``model``, as the reference mutates the model between draws."""
    hmc_cfg = HMCConfig()
    noise_mu, noise_sigma, infer = model.noise_prior
    x, y, m = model._batched_data()
    xs = model._tensor(model._normalize_dates(dates))
    mu_p, sg_p, act_p = (model._tensor(a) for a in
                         prior_arrays(model._host_types, model.config))
    lw = model._tensor(model.log_weight - model.log_weight.max())
    samples, params, log_noise, lml, scale = forecast_hmc_scan(
        model._types_d(), model._params_d, model._log_noise_d,
        mu_p, sg_p, act_p, x, y, m, xs, lw, model._gen, model._eps_scale_d,
        n_draws=n_draws, n_hmc=n_hmc, n_leapfrog=hmc_cfg.n_leapfrog,
        step_size=hmc_cfg.step_size, step_jitter=hmc_cfg.step_size_jitter,
        jitter=DEFAULT_JITTER, noise_mu=noise_mu, noise_sigma=noise_sigma,
        infer_noise=infer,
    )
    model._params_d, model._log_noise_d = params, log_noise
    model._lml_d, model._eps_scale_d = lml, scale
    out = samples.cpu().numpy().astype(np.float64)
    return model._y_mean + model._y_std * out
