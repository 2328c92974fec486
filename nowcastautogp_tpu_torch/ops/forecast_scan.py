"""Per-draw-HMC forecasting: refresh the hyperparameters before every draw.

Port of the JAX package's ``ops/forecast_scan.py``: ``forecast_hmc_scan``
(the reference forecaster's ``forecast_n_hmc`` path, which mutates the model
between draws) and ``nowcast_forecast_hmc_scan`` (the same over the
flattened scenario x particle rows of a nowcast).  The JAX package runs the
draw loop as one ``lax.scan``; here it is a Python loop over draws, each
running ``run_hmc`` (which evaluates the initial gradient again, as
``_hmc_batched`` does), then the predictive, then mixture components and
joint normal draws from the caller's ``torch.Generator``.  Nothing waits
for the device except the predictive's eigendecomposition.
"""

from __future__ import annotations

import torch

from ..inference.hmc import run_hmc
from .lml import DEFAULT_JITTER, gp_predict_batch, sampling_cholesky

__all__ = ["forecast_hmc_scan", "nowcast_forecast_hmc_scan"]


def forecast_hmc_scan(
    types, params, log_noise, prior_mu, prior_sigma, prior_active,
    x, y, mask, xs, log_w, gen, eps_scale, *,
    n_draws, n_hmc, n_leapfrog, step_size, step_jitter,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
):
    """Draws ``n_draws`` joint samples with ``n_hmc`` HMC steps before each.

    All particle tensors carry the leading axis; ``x``/``y``/``mask`` are
    per-particle rows, ``xs`` (m,) is shared.  Parameter-only HMC leaves the
    importance weights unchanged, so ``log_w`` (P,) is fixed across draws,
    as in the reference.

    Returns (samples (m, n_draws), params, log_noise, lml, eps_scale).
    """
    probs = torch.softmax(log_w, -1)
    lml = None
    samples = []
    for _ in range(n_draws):
        params, log_noise, lml, _, eps_scale, _ = run_hmc(
            types, params, log_noise, prior_mu, prior_sigma, prior_active,
            x, y, mask, gen, n_steps=n_hmc, n_leapfrog=n_leapfrog,
            step_size=step_size, step_jitter=step_jitter, jitter=jitter,
            noise_mu=noise_mu, noise_sigma=noise_sigma,
            infer_noise=infer_noise, eps_scale=eps_scale,
        )
        with torch.no_grad():
            mu, cov = gp_predict_batch(types, params, log_noise, x, y, mask,
                                       xs, jitter, True)
            chol = sampling_cholesky(cov)
            comp = torch.multinomial(probs, 1, generator=gen)        # (1,)
            eps = torch.randn(xs.shape[-1], generator=gen, device=mu.device,
                              dtype=mu.dtype)
            samples.append(mu.index_select(0, comp)[0]
                           + chol.index_select(0, comp)[0] @ eps)
    return torch.stack(samples, 1), params, log_noise, lml, eps_scale


def nowcast_forecast_hmc_scan(
    types, params, log_noise, prior_mu, prior_sigma, prior_active,
    x, y, mask, xs, log_w, gen, eps_scale, *,
    n_scenarios, n_draws, n_hmc, n_leapfrog, step_size, step_jitter,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
):
    """Scenario-batched per-draw-HMC forecasting over R = S x P rows.

    Each draw refreshes all rows with ``n_hmc`` HMC steps, then draws one
    mixture component per scenario from its own (S, P) log-weights
    ``log_w`` (unchanged by parameter-only HMC) and one joint sample from
    that row's predictive.  Only the S drawn rows' predictives are built:
    each row's predictive is a function of that row alone, so this is the
    reference's all-rows predictive indexed at the draws.

    Returns (samples (m, S * n_draws), scenario s in columns s·D ...
    (s+1)·D - 1, params, log_noise, eps_scale).
    """
    S = n_scenarios
    P = params.shape[0] // S
    m = xs.shape[-1]
    probs = torch.softmax(log_w, -1)                             # (S, P)
    offsets = torch.arange(S, device=params.device) * P
    samples = []
    for _ in range(n_draws):
        params, log_noise, _, _, eps_scale, _ = run_hmc(
            types, params, log_noise, prior_mu, prior_sigma, prior_active,
            x, y, mask, gen, n_steps=n_hmc, n_leapfrog=n_leapfrog,
            step_size=step_size, step_jitter=step_jitter, jitter=jitter,
            noise_mu=noise_mu, noise_sigma=noise_sigma,
            infer_noise=infer_noise, eps_scale=eps_scale,
        )
        with torch.no_grad():
            comp = torch.multinomial(probs, 1, generator=gen)[:, 0]
            rows = comp + offsets                                # (S,)
            mu, cov = gp_predict_batch(
                types[rows], params[rows], log_noise[rows], x[rows],
                y[rows], mask[rows], xs, jitter, True)
            eps = torch.randn(S, m, generator=gen, device=mu.device,
                              dtype=mu.dtype)
            samples.append(mu + torch.einsum(
                "sij,sj->si", sampling_cholesky(cov), eps))
    # (D, S, m) -> (m, S * D): scenario s's draws are columns s*D to
    # (s+1)*D - 1
    out = torch.stack(samples).permute(2, 1, 0).reshape(m, S * n_draws)
    return out, params, log_noise, eps_scale
