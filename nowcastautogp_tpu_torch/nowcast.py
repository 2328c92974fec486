"""Nowcast scenarios and nowcast-conditioned forecasts.

Port of the JAX package's ``nowcast.py``.  ``forecast_with_nowcasts``
conditions the fitted ensemble on each nowcast scenario and forecasts from
it, by one of three branches, chosen as the reference chooses them:

* scenarios with different date axes: the serial branch, one model copy per
  scenario (``add_data``, ``maybe_resample``, ``mcmc_structure`` or
  ``mcmc_parameters``, ``forecast``);
* shared dates and no particle refresh: the shared-Cholesky branch.  The
  covariance, its Cholesky factor and the predictive covariance are
  computed once per *particle* and the S scenario targets ride as extra
  right-hand sides; mixture components are drawn from the per-scenario
  importance weights, which samples the same mixture as
  resample-then-draw;
* shared dates with a refresh (``n_mcmc``, ``n_hmc``, ``forecast_n_hmc``):
  the batched branch.  The ensemble is tiled to R = S x P rows with
  per-row data buffers, and the reweight, the per-scenario ESS resample,
  the HMC or device-proposal refresh and the draws are batched calls over
  all rows (in chunks of scenarios, ``_scenario_chunk``).

The output contract is the reference's: a ``(n_dates, n_scenarios *
draws_per_nowcast)`` matrix with columns grouped by scenario, and the base
model is never mutated.  Draws are a pure function of (base state, inputs):
each branch's generators are seeded from a hash of the base model's
generator states, a call-site salt, ``draw_seed`` and the nowcast data.
"""

from __future__ import annotations

import copy
import hashlib
import logging

import numpy as np
import torch

from .forecasting import forecast
from .inference.device_smc import rejuvenation_sweep
from .inference.hmc import run_hmc
from .inference.resample import ess, resample_indices
from .models.config import HMCConfig
from .models.gp_model import (
    _PAD, GPModel, _seeded_generator, add_data, maybe_resample,
    mcmc_parameters, mcmc_structure,
)
from .models.structures import prior_arrays
from .models.structures_device import ancestor_table, config_arrays
from .ops.cov import cov_fn
from .ops.forecast_scan import nowcast_forecast_hmc_scan
from .ops.lml import (
    DEFAULT_JITTER, LOG_2PI, budget_rows, gp_lml_batched, gp_predict_batch,
    masked_kernel_matrix, sampling_cholesky,
)
from .ops.megalml import cholesky_nan
from .tdata import create_transformed_data
from .utils.apply import apply_elementwise
from .utils.dates import as_date_array, dates_to_float
from .utils.profiling import readback, span

__all__ = ["create_nowcast_data", "forecast_with_nowcasts"]

logger = logging.getLogger("nowcastautogp_tpu_torch")

# Scenario chunking of the batched branch: each of the S x P rows holds a
# few (cap, cap) float32 matrices at once on the card, budgeted as the
# composed LML core budgets its particles (ops/lml.py).  chip_smoke.py's
# phase 6 measures the peak where the budget binds (capacity 576, 16
# scenarios of 200 rows a chunk): 5.07 matrices a row, 21.5 GB, on an
# NVIDIA H100 80GB HBM3 at 700 W.


def create_nowcast_data(nowcasts, dates, *, transformation=lambda y: y):
    """Build ``TData`` scenario containers from nowcast draws.

    Accepts either a sequence of per-scenario value vectors or a matrix whose
    *columns* are scenarios (rows = dates).  Every scenario must match
    ``len(dates)``, the set must be non-empty, and all scenarios must have
    equal length.
    """
    with span("api/create_nowcast_data"):
        if isinstance(nowcasts, np.ndarray) and nowcasts.ndim == 2:
            scenarios = [nowcasts[:, j] for j in range(nowcasts.shape[1])]
        else:
            scenarios = [np.asarray(list(v) if not isinstance(v, np.ndarray)
                                    else v) for v in nowcasts]
        dates = list(dates)
        if len(scenarios) == 0:
            raise ValueError("nowcasts must not be empty")
        if not all(len(s) == len(dates) for s in scenarios):
            raise ValueError(
                "Length of each nowcast must match length of dates")
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
    requires ``n_hmc > 0``; ``0 <= ess_threshold <= 1`` (a fraction of the
    ensemble); ``forecast_n_hmc`` (if given) must be positive and refreshes
    the hyperparameters before every draw.  The branch follows the
    module docstring; on the shared-Cholesky branch ``ess_threshold`` has no
    effect on the sampled mixture.  The work runs on ``base_model.device``.
    """
    with span("api/forecast_with_nowcasts"):
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
        D = int(forecast_draws_per_nowcast)
        kw = dict(inv_transformation=inv_transformation, n_mcmc=n_mcmc,
                  n_hmc=n_hmc, ess_threshold=ess_threshold,
                  forecast_n_hmc=forecast_n_hmc, verbose=verbose,
                  draw_seed=draw_seed)
        if not _shared_dates(nowcasts):
            return _forecast_with_nowcasts_serial(
                base_model, nowcasts, forecast_dates, D, **kw)
        if n_mcmc == 0 and n_hmc == 0 and forecast_n_hmc is None:
            return _forecast_with_nowcasts_shared_chol(
                base_model, nowcasts, forecast_dates, D,
                inv_transformation=inv_transformation, verbose=verbose,
                draw_seed=draw_seed,
            )
        S = len(nowcasts)
        chunk = _scenario_chunk(base_model, nowcasts)
        blocks = []
        for lo in range(0, S, chunk):
            part = nowcasts[lo:lo + chunk]
            blocks.append(_forecast_with_nowcasts_batched(
                base_model, part, forecast_dates, D, **kw))
            if verbose and chunk < S:
                logger.info("nowcast chunk %d-%d/%d done", lo,
                            lo + len(part), S)
        return np.concatenate(blocks, axis=1)


def _scenario_chunk(base_model, nowcasts) -> int:
    """Scenarios per batched call: as many as the budget of one call holds
    (``ops/lml.py``'s ``budget_rows``, P rows a scenario), at least one.
    Unlike the JAX package, a chunk is not padded: nothing is compiled per
    shape here."""
    cap = _scenario_cap(base_model, nowcasts[0].ds)
    fit = budget_rows(cap) // base_model.num_particles
    return min(max(fit, 1), len(nowcasts))


def _forecast_with_nowcasts_serial(
    base_model, nowcasts, forecast_dates, draws_per_nowcast, *,
    inv_transformation, n_mcmc, n_hmc, ess_threshold, forecast_n_hmc, verbose,
    draw_seed=None,
):
    """General branch: an independent model copy per scenario.

    Each copy gets fresh generators derived by hashing, not advancing, the
    base state (the restored state would replay one stream in every copy).
    """
    base_dict = base_model.to_dict()
    blocks = []
    for i, nc in enumerate(nowcasts):
        model = GPModel(copy.deepcopy(base_dict))
        ss_rng, ss_gen = _scenario_seed_seq(
            base_model, i, [nc], draw_seed).spawn(2)
        model.rng = np.random.default_rng(ss_rng)
        model._gen = _seeded_generator(model.device,
                                       ss_gen.generate_state(1)[0])
        add_data(model, nc.ds, nc.y)
        maybe_resample(model, ess_threshold * model.num_particles)
        if n_mcmc > 0 and n_hmc > 0:
            mcmc_structure(model, n_mcmc, n_hmc)
        elif n_mcmc == 0 and n_hmc > 0:
            mcmc_parameters(model, n_hmc)
        blocks.append(forecast(
            model, forecast_dates, draws_per_nowcast,
            inv_transformation=inv_transformation,
            forecast_n_hmc=forecast_n_hmc))
        if verbose:
            logger.info("Nowcast scenario %d/%d done", i + 1, len(nowcasts))
    return np.concatenate(blocks, axis=1)


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


def _scenario_cap(base_model, nc_ds) -> int:
    """Capacity of the scenario rows: the base buffer's, or the next
    ``_PAD`` multiple that holds the ingested data and the nowcast block."""
    n_new = base_model.n_ingested + len(nc_ds)
    return max(base_model._cap, int(np.ceil(n_new / _PAD)) * _PAD)


def _scenario_buffers(base_model, nowcasts):
    """Shared time axis, per-scenario targets and old/new masks (numpy)."""
    S = len(nowcasts)
    n0 = base_model.n_ingested
    nc_ds = nowcasts[0].ds
    n_new = n0 + len(nc_ds)
    cap = _scenario_cap(base_model, nc_ds)
    x_row = np.zeros(cap, dtype=np.float32)
    x_row[:n0] = readback(base_model._x_d[:n0])
    x_row[n0:n_new] = base_model._normalize_dates(nc_ds)
    y_rows = np.zeros((S, cap), dtype=np.float32)
    y_rows[:, :n0] = readback(base_model._y_d[:n0])
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
    with span("nowcast/rows"):
        x_row, y_rows, mask_old, mask_new = _scenario_buffers(base_model,
                                                              nowcasts)
        xs = base_model._normalize_dates(list(forecast_dates))
        t = base_model._tensor
        args = (base_model._types_d(), base_model._params_d,
                base_model._log_noise_d, t(x_row), t(y_rows), t(mask_old),
                t(mask_new), t(base_model.log_weight), t(xs))
    # one call gives the reweight and the predictive moments together
    with span("nowcast/draws"), torch.no_grad():
        log_w, mu, chol = _shared_chol_moments(*args)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(_scenario_seed_seq(
            base_model, -1, nowcasts, draw_seed).generate_state(1)[0]))
        samples = _shared_chol_sample(log_w, mu, chol, gen,
                                      int(draws_per_nowcast))
        out = readback(samples).astype(np.float64)
    out = base_model._y_mean + base_model._y_std * out
    if verbose:
        logger.info(
            "Shared-Cholesky nowcast forecast: %d scenarios x %d draws",
            len(nowcasts), draws_per_nowcast)
    return apply_elementwise(inv_transformation, out)


def _reweight_delta(lml_old, lml_new):
    """Per-row add_data weight update (float64 numpy): the LML gain, or
    ``-1e10`` where either LML is at the rejection sentinel.  A broken OLD
    value would otherwise give delta ~ +1e10 and hand that particle all the
    weight."""
    return np.where((lml_old <= -1e9) | (lml_new <= -1e9), -1e10,
                    lml_new - lml_old)


def _resample_rows(rng, log_w, S, P, ess_threshold):
    """Per-scenario ESS resampling of the flattened rows (host index math).

    Scenario s's P rows are resampled from their own weights when their
    ESS is below ``ess_threshold * P``, and their weights reset to 0.
    Returns (flat row indices (R,), log_w, whether any scenario resampled);
    ``log_w`` is updated in place.
    """
    flat_idx = np.arange(S * P, dtype=np.int64)
    resampled = False
    for s in range(S):
        sl = slice(s * P, (s + 1) * P)
        if ess(log_w[sl]) < ess_threshold * P:
            flat_idx[sl] = resample_indices(rng, log_w[sl]) + s * P
            log_w[sl] = 0.0
            resampled = True
    return flat_idx, log_w, resampled


def _forecast_with_nowcasts_batched(
    base_model, nowcasts, forecast_dates, draws_per_nowcast, *,
    inv_transformation, n_mcmc, n_hmc, ess_threshold, forecast_n_hmc, verbose,
    draw_seed=None,
):
    """Batched branch: the flattened scenario x particle rows on the device.

    Equal in distribution to the serial branch (each scenario conditions an
    independent copy of the ensemble), but every numerical step is one call
    over all S x P rows: the old and new LMLs of the reweight, one gather
    for the resample, the refresh (``run_hmc`` for ``n_hmc`` alone, the
    device-proposal ``rejuvenation_sweep`` for ``n_mcmc > 0``) and the
    draws (``nowcast_forecast_hmc_scan`` with ``forecast_n_hmc``).
    """
    S = len(nowcasts)
    P = base_model.num_particles
    R = S * P
    D = int(draws_per_nowcast)
    dev = base_model.device
    hmc_cfg = HMCConfig()
    noise_mu, noise_sigma, infer = base_model.noise_prior
    t = base_model._tensor
    with span("nowcast/rows"):
        x_row, y_rows, mask_old, mask_new = _scenario_buffers(base_model,
                                                              nowcasts)
        cap = x_row.shape[0]
        x_b = t(x_row).expand(R, cap)
        y_b = t(np.repeat(y_rows, P, axis=0))
        m_old = t(mask_old).expand(R, cap)
        m_new = t(mask_new).expand(R, cap)

        # the particle state tiled across scenarios: row s * P + p
        host_types = np.tile(base_model._host_types, (S, 1))
        types_d = torch.as_tensor(host_types, device=dev)
        params = base_model._params_d.repeat(S, 1, 1)
        log_noise = base_model._log_noise_d.repeat(S)
        eps_scale = base_model._eps_scale_d.repeat(S)

    # the cached LML may be on a different (shuffled) buffer: both sides of
    # the add_data delta are evaluated on this one
    with span("nowcast/reweight"):
        with torch.no_grad():
            lml_old = gp_lml_batched(types_d, params, log_noise, x_b, y_b,
                                     m_old, DEFAULT_JITTER)
            lml = gp_lml_batched(types_d, params, log_noise, x_b, y_b, m_new,
                                 DEFAULT_JITTER)
        log_w = np.tile(base_model.log_weight, S) + _reweight_delta(
            readback(lml_old).astype(np.float64),
            readback(lml).astype(np.float64))

    if ess_threshold > 0:
        with span("nowcast/resample"):
            rng = np.random.default_rng(
                _scenario_seed_seq(base_model, -2, nowcasts, draw_seed))
            flat_idx, log_w, resampled = _resample_rows(rng, log_w, S, P,
                                                        ess_threshold)
            if resampled:
                idx = torch.as_tensor(flat_idx, device=dev)
                params, log_noise, lml, eps_scale, types_d = (
                    a[idx] for a in (params, log_noise, lml, eps_scale,
                                     types_d))
                host_types = host_types[flat_idx]

    gen = _seeded_generator(dev, _scenario_seed_seq(
        base_model, -3, nowcasts, draw_seed).generate_state(1)[0])
    hmc_kw = dict(n_leapfrog=hmc_cfg.n_leapfrog, step_size=hmc_cfg.step_size,
                  step_jitter=hmc_cfg.step_size_jitter, jitter=DEFAULT_JITTER,
                  noise_mu=noise_mu, noise_sigma=noise_sigma,
                  infer_noise=infer)
    if n_mcmc > 0:
        cfg = config_arrays(base_model.config, dev)
        anc = torch.as_tensor(ancestor_table(base_model.config.max_nodes),
                              device=dev)
        with span("nowcast/refresh"):
            types_d, params, log_noise, lml, _, eps_scale = rejuvenation_sweep(
                types_d, params, log_noise, lml, x_b, y_b, m_new, gen, cfg,
                anc, n_mcmc=int(n_mcmc), n_hmc=int(n_hmc),
                eps_scale=eps_scale, **hmc_kw)
            host_types = readback(types_d)
    elif n_hmc > 0:
        with span("nowcast/priors"):
            mu, sg, act = (t(a) for a in prior_arrays(host_types,
                                                      base_model.config))
        with span("nowcast/refresh"):
            params, log_noise, lml, _, eps_scale, _ = run_hmc(
                types_d, params, log_noise, mu, sg, act, x_b, y_b, m_new, gen,
                n_steps=int(n_hmc), eps_scale=eps_scale, **hmc_kw)

    if forecast_n_hmc is not None:
        with span("nowcast/priors"):
            mu_pr, sg_pr, act_pr = (t(a) for a in prior_arrays(
                host_types, base_model.config))
    with span("nowcast/draws"):
        xs = t(base_model._normalize_dates(list(forecast_dates)))
        logw_d = t(log_w.reshape(S, P)
                   - log_w.reshape(S, P).max(1, keepdims=True))
        if forecast_n_hmc is None:
            with torch.no_grad():
                comps = torch.multinomial(torch.softmax(logw_d, -1), D,
                                          replacement=True, generator=gen)
                rows = (comps + torch.arange(S, device=dev)[:, None] * P
                        ).reshape(-1)                            # (S * D,)
                # each row's predictive depends on that row alone, so only
                # the drawn rows' are built
                drawn, inv = torch.unique(rows, return_inverse=True)
                mu, cov = gp_predict_batch(
                    types_d[drawn], params[drawn], log_noise[drawn],
                    x_b[drawn], y_b[drawn], m_new[drawn], xs, DEFAULT_JITTER,
                    True)
                chol = sampling_cholesky(cov)
                eps = torch.randn(S * D, xs.shape[0], generator=gen,
                                  device=dev, dtype=mu.dtype)
                samples = (mu[inv] + torch.einsum("rij,rj->ri", chol[inv],
                                                   eps)).T
        else:
            scan_kw = dict(n_scenarios=S, n_draws=D,
                           n_hmc=int(forecast_n_hmc), **hmc_kw)
            samples, *_ = nowcast_forecast_hmc_scan(
                types_d, params, log_noise, mu_pr, sg_pr, act_pr, x_b, y_b,
                m_new, xs, logw_d, gen, eps_scale, **scan_kw)
        out = readback(samples).astype(np.float64)
    out = base_model._y_mean + base_model._y_std * out
    if verbose:
        logger.info("Batched nowcast forecast: %d scenarios x %d draws", S, D)
    return apply_elementwise(inv_transformation, out)
