"""Multi-jurisdiction panel fitting: many series, one batched program.

Port of the JAX package's ``parallel/panel.py``.  The particle
ensembles of S series are flattened to one ``R = S x P`` row axis with
*per-row* data buffers (each series keeps its own time/target
normalisation), so every SMC phase -- reweight, structure-move accept,
HMC -- is one batched call across all series: K2 for the reweights and K1
for every gradient, at R rows.  Series are annealed on a shared proportion
grid (each step conditions ``ceil(f_k * n_s)`` points of series ``s``), on
capacity-bucketed schedule segments, and resampling is per series (host
index math, one gather on the device).

Spans (``utils/profiling.py``): ``api/fit_panel`` around the fit,
``panel/step`` around each schedule step, inside it ``panel/reweight``
(the LML call and its reads back) and ``panel/resample``, and
``panel/split`` around the final read back; the count
``panel/resampled_series`` takes the series resampled at each step.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..fitting import _stabilize_for_fit
from ..inference.device_smc import rejuvenation_sweep
from ..inference.hmc import run_hmc
from ..inference.resample import ess, resample_indices
from ..inference.schedule import linear_schedule
from ..inference.smc import schedule_segments
from ..inference.structure_mcmc import mcmc_structure_sweep
from ..models.config import GPConfig, HMCConfig
from ..models.gp_model import (
    _PAD, GPModel, _pad_to, _seeded_generator, key_seed, normalized_weights,
    threefry_key_data,
)
from ..models.posterior import MvNormalMixture
from ..models.structures import prior_arrays, sample_particle
from ..models.structures_device import ancestor_table, config_arrays
from ..ops.lml import (
    DEFAULT_JITTER, budget_bytes, budget_rows, gp_lml_batched,
    gp_predict_batch_rows, sampling_cholesky,
)
from ..utils.apply import apply_elementwise
from ..utils.dates import dates_to_float
from ..utils.profiling import count, in_span, readback, span

__all__ = ["fit_panel", "panel_predict_mvn", "forecast_panel"]

logger = logging.getLogger("nowcastautogp_tpu_torch")


def _check_rows(R: int, cap: int):
    """The panel's rows must fit the budget of one batched call
    (``ops/lml.py``'s ``budget_rows``): K1 holds its workspaces for every
    row at once."""
    if R > budget_rows(cap):
        raise ValueError(
            f"a panel of {R} rows at capacity {cap} needs "
            f"{budget_bytes(R, cap) / 2**30:.1f} GiB, above the row budget "
            f"of one call ({budget_rows(cap)} rows); fit fewer series per "
            "call")


@in_span("api/fit_panel")
def fit_panel(
    datasets, *, n_particles: int = 1, smc_data_proportion: float = 0.1,
    n_mcmc, n_hmc, config: GPConfig | None = None,
    hmc_config: HMCConfig | None = None, flat_threshold: float = 1e-3,
    adaptive_rejuvenation: bool = False, ess_fraction: float = 0.5,
    seed: int | None = None, verbose: bool = False,
    engine: str = "device", device="cuda",
) -> list[GPModel]:
    """Fit one GP particle ensemble per series, batched across the panel.

    ``datasets``: sequence of ``TData`` (one per jurisdiction/series).
    Returns a list of fitted ``GPModel``s on ``device`` (same config object
    shared by reference, like the single-series path).

    ``engine="device"`` (default, as in the JAX package) runs each
    rejuvenation as one device-proposal ``rejuvenation_sweep`` over all
    rows and ``n_mcmc`` moves; ``engine="host"`` builds the proposals in
    numpy (``mcmc_structure_sweep``, one call per move).  With
    ``n_mcmc=0`` the rejuvenation is ``n_hmc`` HMC trajectories.  The numpy
    draws (stabilising jitter, data orders, initial particles, resample
    indices) follow the JAX package's generator stream, so for one seed
    they are the JAX package's.
    """
    if engine not in ("host", "device"):
        raise ValueError(f"engine={engine!r}; expected 'host' or 'device'")
    n_mcmc = int(n_mcmc)
    n_hmc = int(n_hmc)
    datasets = list(datasets)
    assert len(datasets) > 0, "datasets must not be empty"
    P = int(n_particles)
    S = len(datasets)
    R = S * P
    config = config if config is not None else GPConfig()
    hmc_cfg = hmc_config or HMCConfig()
    dev = torch.device(device)

    seed_seq = np.random.SeedSequence(seed)
    rng = np.random.default_rng(seed_seq)
    gen = _seeded_generator(dev, seed_seq.generate_state(1)[0])

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- per-series normalization + shared-capacity padded buffers
    lens = [len(d.y) for d in datasets]
    cap = max(64, int(np.ceil(max(lens) / _PAD)) * _PAD)
    _check_rows(R, cap)
    norms, x_rows_s, y_rows_s, orders, y_fits = [], [], [], [], []
    for d in datasets:
        t_raw = dates_to_float(d.ds)
        y_fit = np.asarray(
            _stabilize_for_fit(d.y, flat_threshold=flat_threshold, rng=rng),
            dtype=np.float64,
        )
        t0 = float(t_raw.min())
        t_scale = float(t_raw.max() - t_raw.min()) or 1.0
        y_mean = float(y_fit.mean())
        y_std = float(y_fit.std()) or 1.0
        order = rng.permutation(len(y_fit))
        norms.append((t0, t_scale, y_mean, y_std))
        orders.append(order)
        y_fits.append(y_fit)
        x_rows_s.append(_pad_to(((t_raw - t0) / t_scale)[order], cap))
        y_rows_s.append(_pad_to(((y_fit - y_mean) / y_std)[order], cap))

    x_b = on_dev(np.repeat(np.stack(x_rows_s), P, axis=0))  # (R, cap)
    y_b = on_dev(np.repeat(np.stack(y_rows_s), P, axis=0))
    lens_row = np.repeat(np.asarray(lens), P)  # (R,)

    # ---- particle initialization (independent per row)
    ts, ps, lns = [], [], []
    for _ in range(R):
        t, p, ln = sample_particle(rng, config)
        ts.append(t)
        ps.append(p)
        lns.append(ln)
    host_types = np.stack(ts).astype(np.int32)
    types_d = on_dev(host_types, torch.int32)
    params = on_dev(np.stack(ps))
    log_noise = on_dev(np.asarray(lns, np.float32))
    lml = torch.zeros(R, dtype=torch.float32, device=dev)
    eps_scale = torch.ones(R, dtype=torch.float32, device=dev)
    log_w = np.zeros(R, dtype=np.float64)

    wc = config.prior["wildcard"]
    noise_mu, noise_sigma = float(wc["mu"]) - 2.0, float(wc["sigma"])
    infer = 0.0 if config.noise is not None else 1.0
    hmc_kw = dict(n_leapfrog=hmc_cfg.n_leapfrog, step_size=hmc_cfg.step_size,
                  step_jitter=hmc_cfg.step_size_jitter, jitter=DEFAULT_JITTER,
                  noise_mu=noise_mu, noise_sigma=noise_sigma,
                  infer_noise=infer)
    use_device = engine == "device" and n_mcmc > 0
    if use_device:
        cfg_arrays = config_arrays(config, dev)
        anc = torch.as_tensor(ancestor_table(config.max_nodes), device=dev)

    # ---- shared proportion grid: anneal every series together.  Step k
    # conditions at most n_k points of the LONGEST series (shorter series
    # condition ceil(f_k * n_s) <= n_k), so each step runs on the smallest
    # sufficient _PAD-multiple buffer; the masked LML is invariant to the
    # trailing padding, so weights and LML carry across segments.
    n_max = max(lens)
    eff_prop = max(smc_data_proportion, 1.0 / n_max)
    schedule = linear_schedule(n_max, eff_prop)
    step_i = 0
    for cap_k, steps in schedule_segments(schedule, cap):
        x_seg = x_b[:, :cap_k].contiguous()
        y_seg = y_b[:, :cap_k].contiguous()
        iota = np.arange(cap_k)
        for n_k in steps:
            with span("panel/step"):
                f = n_k / n_max
                n_new = np.minimum(
                    np.ceil(f * lens_row).astype(np.int64), lens_row)
                mask_b = on_dev((iota[None, :] < n_new[:, None]).astype(
                    np.float32))
                with span("panel/reweight"):
                    with torch.no_grad():
                        lml_new = gp_lml_batched(
                            types_d, params, log_noise, x_seg, y_seg, mask_b,
                            DEFAULT_JITTER)
                    lml_new_np = readback(lml_new).astype(np.float64)
                    lml_old_np = readback(lml).astype(np.float64)
                    # sentinel guard: a particle broken on either side of the
                    # reweight must lose weight, not gain ~1e10 of it
                    log_w += np.where(
                        (lml_old_np <= -1e9) | (lml_new_np <= -1e9), -1e10,
                        lml_new_np - lml_old_np)
                lml = lml_new

                # per-series ESS resampling: host index math, one gather
                with span("panel/resample"):
                    low = []
                    flat_idx = np.arange(R, dtype=np.int64)
                    for s in range(S):
                        sl = slice(s * P, (s + 1) * P)
                        if P > 1 and ess(log_w[sl]) < ess_fraction * P:
                            flat_idx[sl] = (resample_indices(rng, log_w[sl])
                                            + s * P)
                            log_w[sl] = 0.0
                            low.append(s)
                    if low:
                        idx = on_dev(flat_idx, torch.int64)
                        params, log_noise, lml, eps_scale = (
                            a[idx]
                            for a in (params, log_noise, lml, eps_scale))
                        host_types = host_types[flat_idx]
                        types_d = on_dev(host_types, torch.int32)
                count("panel/resampled_series", len(low))
                do_rejuvenate = bool(low) or not adaptive_rejuvenation
                if do_rejuvenate and use_device:
                    types_d, params, log_noise, lml, _, eps_scale = (
                        rejuvenation_sweep(
                            types_d, params, log_noise, lml, x_seg, y_seg,
                            mask_b, gen, cfg_arrays, anc, n_mcmc=n_mcmc,
                            n_hmc=n_hmc, eps_scale=eps_scale, **hmc_kw))
                    host_types = readback(types_d).astype(np.int32)
                elif do_rejuvenate and n_mcmc > 0:
                    (host_types, params, log_noise, lml, _,
                     eps_scale) = mcmc_structure_sweep(
                        rng, gen, host_types, params, log_noise, lml, x_seg,
                        y_seg, mask_b, config, n_mcmc, n_hmc, hmc_cfg,
                        DEFAULT_JITTER, noise_mu, noise_sigma, infer,
                        eps_scale)
                    types_d = on_dev(host_types, torch.int32)
                elif do_rejuvenate and n_hmc > 0:
                    mu, sg, act = (on_dev(a) for a in
                                   prior_arrays(host_types, config))
                    params, log_noise, lml, _, eps_scale, _ = run_hmc(
                        types_d, params, log_noise, mu, sg, act, x_seg, y_seg,
                        mask_b, gen, n_steps=n_hmc, eps_scale=eps_scale,
                        **hmc_kw)
            step_i += 1
            if verbose:
                logger.info("panel SMC step %d/%d: n=%d cap=%d resampled "
                            "%d/%d series", step_i, len(schedule), n_k,
                            cap_k, len(low), S)

    # ---- split rows back into per-series GPModels: the state's one read
    # back after the loop, in a span of its own
    with span("panel/split"):
        params_np = params.cpu().numpy()
        log_noise_np = log_noise.cpu().numpy()
        lml_np = lml.cpu().numpy()
        scale_np = eps_scale.cpu().numpy()
    models = []
    for s, d in enumerate(datasets):
        sl = slice(s * P, (s + 1) * P)
        t0, t_scale, y_mean, y_std = norms[s]
        sub_seed = seed_seq.generate_state(2 + s)[-1]
        sub_gen = _seeded_generator(dev, key_seed(threefry_key_data(sub_seed)))
        models.append(GPModel({
            "version": 1,
            "ds": d.ds,
            "y": y_fits[s],  # the (possibly jitter-stabilized) fitted targets
            "order": orders[s].astype(np.int64),
            "n_ingested": lens[s],
            "t0": t0, "t_scale": t_scale, "y_mean": y_mean, "y_std": y_std,
            "node_types": host_types[sl],
            "params": params_np[sl],
            "log_noise": log_noise_np[sl],
            "lml": lml_np[sl],
            "log_weight": log_w[sl].copy(),
            "hmc_eps_scale": scale_np[sl],
            "config": config,
            "rng_state": np.random.default_rng(
                int(sub_seed)).bit_generator.state,
            "device": str(dev),
            "generator_state": sub_gen.get_state().numpy(),
        }))
    return models


def _panel_predict_rows(models, forecast_dates, *, include_noise):
    """One batched predictive build over the panel's S x P flattened rows.

    Returns (mu, F, w) as float64 numpy on the ORIGINAL y scale of each
    series: ``mu`` (S, P, nq) predictive means, ``F`` (S, P, nq, nq) PSD
    sampling factors (``sampling_cholesky``) and the per-series normalized
    weights (S, P).
    """
    models = list(models)
    assert len(models) > 0, "models must not be empty"
    P = models[0].num_particles
    assert all(m.num_particles == P for m in models), (
        "panel forecast requires a shared particle count")
    S = len(models)
    dev = models[0].device
    dates = list(forecast_dates)
    nq = len(dates)
    cap = max(int(m._cap) for m in models)

    x_rows = np.zeros((S, cap), dtype=np.float32)
    y_rows = np.zeros((S, cap), dtype=np.float32)
    m_rows = np.zeros((S, cap), dtype=np.float32)
    xs_rows = np.zeros((S, nq), dtype=np.float32)
    types_l, params_l, noise_l, w_rows = [], [], [], []
    for s, model in enumerate(models):
        c = int(model._cap)
        x_rows[s, :c] = readback(model._x_d)
        y_rows[s, :c] = readback(model._y_d)
        m_rows[s, :c] = readback(model._mask())
        xs_rows[s] = model._normalize_dates(dates).astype(np.float32)
        types_l.append(model._host_types)
        params_l.append(model._params_d.to(dev))
        noise_l.append(model._log_noise_d.to(dev))
        w_rows.append(normalized_weights(model))

    def rep(a):  # (S, k) -> (R, k)
        return torch.as_tensor(np.repeat(a, P, axis=0), device=dev)

    types = torch.as_tensor(np.concatenate(types_l).astype(np.int32),
                            device=dev)
    rows = (types, torch.cat(params_l), torch.cat(noise_l), rep(x_rows),
            rep(y_rows), rep(m_rows), rep(xs_rows))

    with torch.no_grad():
        mu, cov = gp_predict_batch_rows(*rows, DEFAULT_JITTER, include_noise)
        mu, F = readback(mu), readback(sampling_cholesky(cov))

    mu = mu.astype(np.float64).reshape(S, P, nq)
    F = F.astype(np.float64).reshape(S, P, nq, nq)
    y_mean = np.asarray([m._y_mean for m in models])[:, None, None]
    y_std = np.asarray([m._y_std for m in models])[:, None, None]
    mu = y_mean + y_std * mu
    F = y_std[..., None] * F
    return mu, F, np.stack(w_rows)


def panel_predict_mvn(models, forecast_dates, *,
                      include_noise: bool = True) -> list[MvNormalMixture]:
    """``predict_mvn`` for a whole panel in one batched predictive build.

    Equivalent per series to ``predict_mvn(models[s], forecast_dates)``
    but assembled as one S x P row-flattened call (one K4 launch for
    K(x, x) on the card).  Returns one mixture per series.
    """
    models = list(models)
    mu, F, w = _panel_predict_rows(models, list(forecast_dates),
                                   include_noise=include_noise)
    out = []
    for s in range(len(models)):
        cov = np.einsum("pij,pkj->pik", F[s], F[s])
        out.append(MvNormalMixture(w[s], mu[s], cov))
    return out


def forecast_panel(models, forecast_dates, forecast_draws: int, *,
                   inv_transformations=None, include_noise: bool = True,
                   seed: int | None = None) -> list[np.ndarray]:
    """Sample forecasts for every series of a fitted panel at once.

    The panel analog of :func:`..forecasting.forecast` (no per-draw HMC):
    one batched predictive build + PSD factorization for all S x P rows,
    then per-series mixture draws with numpy, as the JAX package draws
    them.  ``inv_transformations``: one callable shared by all series, or a
    sequence of per-series callables.  Returns a list of ``(n_dates,
    forecast_draws)`` arrays.
    """
    models = list(models)
    S = len(models)
    dates = list(forecast_dates)
    nq = len(dates)
    n_draws = int(forecast_draws)
    if inv_transformations is None:
        invs = [lambda y: y] * S
    elif callable(inv_transformations):
        invs = [inv_transformations] * S
    else:
        invs = list(inv_transformations)
        assert len(invs) == S, "need one inverse transformation per series"

    mu, F, w = _panel_predict_rows(models, dates, include_noise=include_noise)
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        comps = rng.choice(w.shape[1], size=n_draws, p=w[s])
        eps = rng.standard_normal((n_draws, nq))
        # (n_draws, nq): mu[comp] + F[comp] @ eps  per draw
        draws = mu[s][comps] + np.einsum("dij,dj->di", F[s][comps], eps)
        out.append(apply_elementwise(invs[s], draws.T))
    return out
