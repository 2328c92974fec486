"""Nowcast scenarios and nowcast-conditioned forecasts.

Port of the JAX package's ``nowcast.py`` on its no-refresh shared-date
branch: every scenario shares the base model's time axis and differs only
in the nowcast block of the target vector, so the covariance, its Cholesky
factor and the predictive covariance are computed once per *particle* and
the S scenario targets ride as extra right-hand sides.  Mixture components
are drawn from the per-scenario importance weights, which samples the same
mixture as resample-then-draw.

The output contract is the reference's: a ``(n_dates, n_scenarios *
draws_per_nowcast)`` matrix with columns grouped by scenario, and the base
model is never mutated.  Draws are a pure function of (base state, inputs):
the scenario generator is seeded from a hash of the base model's generator
states, a call-site salt, ``draw_seed`` and the nowcast data.
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from .models.gp_model import _PAD, GPModel
from .ops.cov import cov_fn
from .ops.lml import (
    DEFAULT_JITTER, LOG_2PI, masked_kernel_matrix, sampling_cholesky,
)
from .ops.megalml import cholesky_nan
from .tdata import create_transformed_data
from .utils.apply import apply_elementwise
from .utils.dates import as_date_array, dates_to_float

__all__ = ["create_nowcast_data", "forecast_with_nowcasts"]

logger = logging.getLogger("nowcastautogp_tpu_torch")

_NOT_PORTED = (
    "{} is not ported yet (ROADMAP.md, modules to port: the batched and "
    "serial nowcast branches)")


def create_nowcast_data(nowcasts, dates, *, transformation=lambda y: y):
    """Build ``TData`` scenario containers from nowcast draws.

    Accepts either a sequence of per-scenario value vectors or a matrix whose
    *columns* are scenarios (rows = dates).  Every scenario must match
    ``len(dates)``, the set must be non-empty, and all scenarios must have
    equal length.
    """
    if isinstance(nowcasts, np.ndarray) and nowcasts.ndim == 2:
        scenarios = [nowcasts[:, j] for j in range(nowcasts.shape[1])]
    else:
        scenarios = [np.asarray(list(v) if not isinstance(v, np.ndarray) else v)
                     for v in nowcasts]
    dates = list(dates)
    if len(scenarios) == 0:
        raise ValueError("nowcasts must not be empty")
    if not all(len(s) == len(dates) for s in scenarios):
        raise ValueError("Length of each nowcast must match length of dates")
    return [
        create_transformed_data(dates, s, transformation=transformation)
        for s in scenarios
    ]


def _shared_dates(nowcasts) -> bool:
    first = nowcasts[0].ds
    return all(
        len(nc.ds) == len(first)
        and bool(np.all(as_date_array(nc.ds) == as_date_array(first)))
        for nc in nowcasts[1:]
    )


def _hash_rng_state(h, bit_generator) -> None:
    """Feed a numpy ``BitGenerator`` state into ``h`` via canonical fields
    (fixed-width bytes, invariant to numpy's repr)."""
    st = bit_generator.state
    h.update(str(st.get("bit_generator", "")).encode())
    inner = st.get("state", {})
    items = sorted(inner.items()) if isinstance(inner, dict) else [
        ("state", inner)]
    for k, v in items:
        h.update(k.encode())
        if isinstance(v, (int, np.integer)):
            h.update(int(v).to_bytes(32, "little", signed=False))
        else:
            h.update(np.ascontiguousarray(v).tobytes())
    h.update(int(st.get("has_uint32", 0)).to_bytes(2, "little"))
    h.update(int(st.get("uinteger", 0)).to_bytes(8, "little"))


def _scenario_seed_seq(base_model, salt: int, nowcasts,
                       draw_seed: int | None = None) -> np.random.SeedSequence:
    """Scenario randomness derived from — without advancing — the base
    model's numpy and torch generator states, a call-site salt, the optional
    ``draw_seed`` and the scenario targets."""
    h = hashlib.sha256()
    _hash_rng_state(h, base_model.rng.bit_generator)
    h.update(base_model._gen.get_state().numpy().tobytes())
    h.update(salt.to_bytes(8, "little", signed=True))
    if draw_seed is not None:
        h.update(b"draw_seed")
        h.update(int(draw_seed).to_bytes(8, "little", signed=True))
    for nc in nowcasts:
        h.update(np.ascontiguousarray(np.asarray(nc.y, np.float64)).tobytes())
        h.update(np.ascontiguousarray(
            dates_to_float(nc.ds).astype(np.float64)).tobytes())
    return np.random.SeedSequence(
        np.frombuffer(h.digest()[:16], np.uint32).tolist())


def forecast_with_nowcasts(
    base_model: GPModel, nowcasts, forecast_dates,
    forecast_draws_per_nowcast: int, *, inv_transformation=lambda y: y,
    n_mcmc: int = 0, n_hmc: int = 0, ess_threshold: float = 0.0,
    forecast_n_hmc: int | None = None, verbose: bool = False,
    draw_seed: int | None = None,
) -> np.ndarray:
    """Forecast conditioned on each nowcast scenario; concat scenario blocks.

    Validation mirrors the reference: non-empty scenarios; ``n_mcmc > 0``
    requires ``n_hmc > 0``; ``0 <= ess_threshold <= 1``; ``forecast_n_hmc``
    (if given) must be positive.  Only the no-refresh shared-date branch is
    ported: scenarios with different date axes, or any particle refresh
    (``n_mcmc``, ``n_hmc``, ``forecast_n_hmc``), raise
    ``NotImplementedError`` (``forecast_n_hmc`` runs in ``forecast``, not
    yet per scenario here).  On that branch ``ess_threshold`` has no effect
    on the sampled mixture.  The work runs on ``base_model.device``.
    """
    nowcasts = list(nowcasts)
    if len(nowcasts) == 0:
        raise ValueError("nowcasts vector must not be empty")
    if n_mcmc > 0 and n_hmc == 0:
        raise ValueError(
            "If n_mcmc > 0, n_hmc must also be > 0 for MCMC refinement")
    if not 0.0 <= ess_threshold <= 1.0:
        raise ValueError("ess_threshold must be between 0 and 1")
    if forecast_n_hmc is not None and forecast_n_hmc <= 0:
        raise ValueError("forecast_n_hmc must be > 0 if specified")
    if not _shared_dates(nowcasts):
        raise NotImplementedError(
            _NOT_PORTED.format("scenarios with different date axes"))
    if n_mcmc > 0 or n_hmc > 0 or forecast_n_hmc is not None:
        raise NotImplementedError(
            _NOT_PORTED.format("particle refresh (n_mcmc, n_hmc, "
                               "forecast_n_hmc)"))
    return _forecast_with_nowcasts_shared_chol(
        base_model, nowcasts, forecast_dates, int(forecast_draws_per_nowcast),
        inv_transformation=inv_transformation, verbose=verbose,
        draw_seed=draw_seed,
    )


def _shared_chol_moments(types, params, log_noise, x, y_scen, mask_old,
                         mask_new, base_logw, xs, jitter=DEFAULT_JITTER):
    """Deterministic part of the shared-Cholesky branch.

    x (cap,) shared; y_scen (S, cap) differs only in the nowcast block;
    masks (cap,); base_logw (P,); xs (m,).  Returns the per-scenario
    log-weights (S, P), predictive means (P, m, S) and sampling factors
    (P, m, m).
    """
    P = params.shape[0]
    cap = x.shape[0]
    m = xs.shape[0]
    x_b = x.expand(P, cap)
    xs_b = xs.expand(P, m)

    def lml(L, ym, alpha, mask):
        quad = torch.einsum("sc,pcs->ps", ym, alpha)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        out = -0.5 * (quad + logdet[:, None] + mask.sum() * LOG_2PI)
        return torch.where(torch.isfinite(out), out, torch.full_like(out, -1e10))

    L = cholesky_nan(masked_kernel_matrix(types, params, log_noise, x_b,
                                          mask_new, jitter))
    ym = y_scen * mask_new                                       # (S, cap)
    alpha = torch.cholesky_solve(ym.T.expand(P, cap, ym.shape[0]), L)
    lml_new = lml(L, ym, alpha, mask_new)                        # (P, S)

    # old-data LML: the conditioning set below mask_old is scenario-invariant
    ym_old = (y_scen[0] * mask_old)[None]                        # (1, cap)
    L_old = cholesky_nan(masked_kernel_matrix(types, params, log_noise, x_b,
                                              mask_old, jitter))
    a_old = torch.cholesky_solve(ym_old.T.expand(P, cap, 1), L_old)
    lml_old = lml(L_old, ym_old, a_old, mask_old)[:, 0]          # (P,)

    # a broken particle must be excluded, not promoted when only its OLD
    # lml is broken
    bad = (lml_new.T <= -1e9) | (lml_old[None, :] <= -1e9)       # (S, P)
    log_w = torch.where(
        bad, torch.full_like(bad, -1e10, dtype=lml_new.dtype),
        base_logw[None, :] + lml_new.T - lml_old[None, :])

    # predictive: covariance shared per particle, means per scenario
    Ks = cov_fn(types, params, x_b, xs_b) * mask_new[None, :, None]
    Kss = cov_fn(types, params, xs_b, xs_b)
    V = torch.linalg.solve_triangular(L, Ks, upper=False)        # (P, cap, m)
    eye = torch.eye(m, dtype=Ks.dtype, device=Ks.device)
    noise = torch.exp(log_noise)[:, None, None]
    cov = Kss - V.transpose(-1, -2) @ V + (noise + jitter) * eye
    chol_pred = sampling_cholesky(cov)
    mu = torch.einsum("pcm,pcs->pms", Ks, alpha)                 # (P, m, S)
    return log_w, mu, chol_pred


def _shared_chol_sample(log_w, mu, chol_pred, gen, n_draws):
    """Sampling part: per scenario, ``n_draws`` mixture components from the
    log-weights and one Gaussian draw each -> samples (m, S * n_draws)
    grouped by scenario."""
    S = log_w.shape[0]
    m = mu.shape[1]
    comps = torch.multinomial(torch.softmax(log_w, -1), n_draws,
                              replacement=True, generator=gen)   # (S, D)
    s_idx = torch.arange(S, device=mu.device).repeat_interleave(n_draws)
    c_flat = comps.reshape(-1)
    eps = torch.randn(S * n_draws, m, generator=gen, device=mu.device,
                      dtype=mu.dtype)
    samples = (mu[c_flat, :, s_idx]
               + torch.einsum("rij,rj->ri", chol_pred[c_flat], eps))
    return samples.T


def _scenario_buffers(base_model, nowcasts):
    """Shared time axis, per-scenario targets and old/new masks (numpy)."""
    S = len(nowcasts)
    n0 = base_model.n_ingested
    nc_ds = nowcasts[0].ds
    n_new = n0 + len(nc_ds)
    cap = max(base_model._cap, int(np.ceil(n_new / _PAD)) * _PAD)
    x_row = np.zeros(cap, dtype=np.float32)
    x_row[:n0] = base_model._x_d[:n0].cpu().numpy()
    x_row[n0:n_new] = base_model._normalize_dates(nc_ds)
    y_rows = np.zeros((S, cap), dtype=np.float32)
    y_rows[:, :n0] = base_model._y_d[:n0].cpu().numpy()
    for s, nc in enumerate(nowcasts):
        y_rows[s, n0:n_new] = (
            np.asarray(nc.y, dtype=np.float64) - base_model._y_mean
        ) / base_model._y_std
    mask_old = (np.arange(cap) < n0).astype(np.float32)
    mask_new = (np.arange(cap) < n_new).astype(np.float32)
    return x_row, y_rows, mask_old, mask_new


def _forecast_with_nowcasts_shared_chol(
    base_model, nowcasts, forecast_dates, draws_per_nowcast, *,
    inv_transformation, verbose, draw_seed=None,
):
    """Host wrapper for the per-particle shared-Cholesky nowcast branch."""
    dev = base_model.device
    x_row, y_rows, mask_old, mask_new = _scenario_buffers(base_model, nowcasts)
    xs = base_model._normalize_dates(list(forecast_dates))
    t = base_model._tensor
    with torch.no_grad():
        log_w, mu, chol = _shared_chol_moments(
            base_model._types_d(), base_model._params_d,
            base_model._log_noise_d, t(x_row), t(y_rows), t(mask_old),
            t(mask_new), t(base_model.log_weight), t(xs))
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(_scenario_seed_seq(
            base_model, -1, nowcasts, draw_seed).generate_state(1)[0]))
        samples = _shared_chol_sample(log_w, mu, chol, gen,
                                      int(draws_per_nowcast))
    out = samples.cpu().numpy().astype(np.float64)
    out = base_model._y_mean + base_model._y_std * out
    if verbose:
        logger.info(
            "Shared-Cholesky nowcast forecast: %d scenarios x %d draws",
            len(nowcasts), draws_per_nowcast)
    return apply_elementwise(inv_transformation, out)
