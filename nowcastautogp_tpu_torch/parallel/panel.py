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

With a ``Mesh`` of several shards (``parallel/sharding.py``) the series
axis is padded with duplicates until the rows divide the mesh, and every
hot call -- reweight LML, device sweep, host move, HMC -- runs one body a
shard, the shards in turn; the padded rows are trimmed from the
result.  The state lives on the mesh's first device between calls.  A
mesh of one shard runs the unsharded calls on its device.
"""

from __future__ import annotations

import logging
import math

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
    _CHUNK_BYTES, _ROW_MATRICES, DEFAULT_JITTER, gp_lml_batched,
    gp_predict_batch_rows, sampling_cholesky,
)
from ..utils.apply import apply_elementwise
from ..utils.dates import dates_to_float
from .sharding import (
    _on_shards, lml_rows_sharded, rejuvenation_sweep_sharded,
    run_hmc_sharded,
)

__all__ = ["fit_panel", "panel_predict_mvn", "forecast_panel"]

logger = logging.getLogger("nowcastautogp_tpu_torch")


def _check_rows(R: int, cap: int, mesh=None):
    """The rows one device holds must fit the byte budget of batched work
    (``ops/lml.py``'s ``_CHUNK_BYTES`` at ``_ROW_MATRICES`` (cap, cap)
    float32 matrices a row): K1 holds its workspaces for every row at
    once.  With a mesh, a device holds its shards' rows."""
    rows = R if mesh is None else math.ceil(R * mesh.device_share())
    need = rows * _ROW_MATRICES * cap * cap * 4
    if need > _CHUNK_BYTES:
        raise ValueError(
            f"a panel of {R} rows ({rows} on one device) at capacity {cap} "
            f"needs {need / 2**30:.1f} GiB, above the "
            f"{_CHUNK_BYTES / 2**30:.0f} GiB row budget; fit fewer series "
            "per call or shard them over more cards")


def _pad_series(items, P: int, mesh):
    """``items`` (one per series) padded with duplicates until S x P rows
    divide the mesh (the JAX package's rule); returns (items, S_real)."""
    S_real = len(items)
    n_dev = mesh.size if mesh is not None else 1
    if n_dev > 1 and (S_real * P) % n_dev != 0:
        s_mult = n_dev // math.gcd(P, n_dev)
        S = -(-S_real // s_mult) * s_mult
        logger.info(
            "padding %d series to %d so %d x %d rows divide the %d-shard "
            "mesh (padded rows are trimmed from the result)",
            S_real, S, S, P, n_dev)
        items = items + [items[i % S_real] for i in range(S - S_real)]
    return items, S_real


def fit_panel(
    datasets, *, n_particles: int = 1, smc_data_proportion: float = 0.1,
    n_mcmc, n_hmc, config: GPConfig | None = None,
    hmc_config: HMCConfig | None = None, flat_threshold: float = 1e-3,
    adaptive_rejuvenation: bool = False, ess_fraction: float = 0.5,
    seed: int | None = None, mesh=None, verbose: bool = False,
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

    ``mesh``: a ``parallel.sharding.Mesh``; with several shards the series
    are padded to a mesh multiple and every hot call runs one body a shard
    (module docstring).  The state then lives on the mesh's first device,
    which takes the place of ``device``.
    """
    if engine not in ("host", "device"):
        raise ValueError(f"engine={engine!r}; expected 'host' or 'device'")
    n_mcmc = int(n_mcmc)
    n_hmc = int(n_hmc)
    datasets = list(datasets)
    assert len(datasets) > 0, "datasets must not be empty"
    P = int(n_particles)
    datasets, S_real = _pad_series(datasets, P, mesh)
    S = len(datasets)
    R = S * P
    config = config if config is not None else GPConfig()
    hmc_cfg = hmc_config or HMCConfig()
    dev = torch.device(device) if mesh is None else mesh.devices[0]
    sweep_mesh = mesh if mesh is not None and mesh.size > 1 else None

    seed_seq = np.random.SeedSequence(seed)
    rng = np.random.default_rng(seed_seq)
    gen = _seeded_generator(dev, seed_seq.generate_state(1)[0])

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- per-series normalization + shared-capacity padded buffers
    lens = [len(d.y) for d in datasets]
    cap = max(64, int(np.ceil(max(lens) / _PAD)) * _PAD)
    _check_rows(R, cap, sweep_mesh)
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
            f = n_k / n_max
            n_new = np.minimum(
                np.ceil(f * lens_row).astype(np.int64), lens_row)
            mask_b = on_dev((iota[None, :] < n_new[:, None]).astype(
                np.float32))
            with torch.no_grad():
                if sweep_mesh is not None:
                    lml_new = lml_rows_sharded(types_d, params, log_noise,
                                               x_seg, y_seg, mask_b,
                                               mesh=sweep_mesh)
                else:
                    lml_new = gp_lml_batched(types_d, params, log_noise,
                                             x_seg, y_seg, mask_b,
                                             DEFAULT_JITTER)
            lml_new_np = lml_new.cpu().numpy().astype(np.float64)
            lml_old_np = lml.cpu().numpy().astype(np.float64)
            # sentinel guard: a particle broken on either side of the
            # reweight must lose weight, not gain ~1e10 of it
            log_w += np.where(
                (lml_old_np <= -1e9) | (lml_new_np <= -1e9), -1e10,
                lml_new_np - lml_old_np)
            lml = lml_new

            # per-series ESS resampling: host index math, one gather
            low = []
            flat_idx = np.arange(R, dtype=np.int64)
            for s in range(S):
                sl = slice(s * P, (s + 1) * P)
                if P > 1 and ess(log_w[sl]) < ess_fraction * P:
                    flat_idx[sl] = resample_indices(rng, log_w[sl]) + s * P
                    log_w[sl] = 0.0
                    low.append(s)
            if low:
                idx = on_dev(flat_idx, torch.int64)
                params, log_noise, lml, eps_scale = (
                    a[idx] for a in (params, log_noise, lml, eps_scale))
                host_types = host_types[flat_idx]
                types_d = on_dev(host_types, torch.int32)
            do_rejuvenate = bool(low) or not adaptive_rejuvenation
            if do_rejuvenate and use_device:
                if sweep_mesh is not None:
                    types_d, params, log_noise, lml, _, eps_scale = (
                        rejuvenation_sweep_sharded(
                            types_d, params, log_noise, lml, x_seg, y_seg,
                            mask_b, gen, eps_scale, cfg_arrays, anc,
                            mesh=sweep_mesh, n_mcmc=n_mcmc, n_hmc=n_hmc,
                            **hmc_kw))
                else:
                    types_d, params, log_noise, lml, _, eps_scale = (
                        rejuvenation_sweep(
                            types_d, params, log_noise, lml, x_seg, y_seg,
                            mask_b, gen, cfg_arrays, anc, n_mcmc=n_mcmc,
                            n_hmc=n_hmc, eps_scale=eps_scale, **hmc_kw))
                host_types = types_d.cpu().numpy().astype(np.int32)
            elif do_rejuvenate and n_mcmc > 0:
                (host_types, params, log_noise, lml, _,
                 eps_scale) = mcmc_structure_sweep(
                    rng, gen, host_types, params, log_noise, lml, x_seg,
                    y_seg, mask_b, config, n_mcmc, n_hmc, hmc_cfg,
                    DEFAULT_JITTER, noise_mu, noise_sigma, infer, eps_scale,
                    mesh=sweep_mesh)
                types_d = on_dev(host_types, torch.int32)
            elif do_rejuvenate and n_hmc > 0:
                mu, sg, act = (on_dev(a) for a in
                               prior_arrays(host_types, config))
                if sweep_mesh is not None:
                    params, log_noise, lml, _, eps_scale = run_hmc_sharded(
                        types_d, params, log_noise, mu, sg, act, x_seg,
                        y_seg, mask_b, gen, eps_scale, mesh=sweep_mesh,
                        n_steps=n_hmc, **hmc_kw)
                else:
                    params, log_noise, lml, _, eps_scale, _ = run_hmc(
                        types_d, params, log_noise, mu, sg, act, x_seg,
                        y_seg, mask_b, gen, n_steps=n_hmc,
                        eps_scale=eps_scale, **hmc_kw)
            step_i += 1
            if verbose:
                logger.info("panel SMC step %d/%d: n=%d cap=%d resampled "
                            "%d/%d series", step_i, len(schedule), n_k,
                            cap_k, len(low), S)

    # ---- split rows back into per-series GPModels
    params_np = params.cpu().numpy()
    log_noise_np = log_noise.cpu().numpy()
    lml_np = lml.cpu().numpy()
    scale_np = eps_scale.cpu().numpy()
    models = []
    for s, d in enumerate(datasets[:S_real]):
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


def _panel_predict_rows(models, forecast_dates, *, include_noise, mesh=None):
    """One batched predictive build over the panel's S x P flattened rows
    (with a mesh of several shards, one build a shard on the series padded
    to a mesh multiple).

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
    shard_mesh = mesh if mesh is not None and mesh.size > 1 else None
    models, S_real = _pad_series(models, P, shard_mesh)
    S = len(models)
    dev = models[0].device if mesh is None else mesh.devices[0]
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
        x_rows[s, :c] = model._x_d.cpu().numpy()
        y_rows[s, :c] = model._y_d.cpu().numpy()
        m_rows[s, :c] = model._mask().cpu().numpy()
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

    def build(*a):
        with torch.no_grad():
            mu, cov = gp_predict_batch_rows(*a, DEFAULT_JITTER, include_noise)
            return mu.cpu(), sampling_cholesky(cov).cpu()

    if shard_mesh is None:
        mu, F = build(*rows)
    else:
        mu, F = (torch.cat(t) for t in zip(*_on_shards(shard_mesh, build,
                                                        rows)))

    mu = mu.numpy().astype(np.float64).reshape(S, P, nq)[:S_real]
    F = F.numpy().astype(np.float64).reshape(S, P, nq, nq)[:S_real]
    y_mean = np.asarray([m._y_mean for m in models[:S_real]])[:, None, None]
    y_std = np.asarray([m._y_std for m in models[:S_real]])[:, None, None]
    mu = y_mean + y_std * mu
    F = y_std[..., None] * F
    return mu, F, np.stack(w_rows[:S_real])


def panel_predict_mvn(models, forecast_dates, *, include_noise: bool = True,
                      mesh=None) -> list[MvNormalMixture]:
    """``predict_mvn`` for a whole panel in one batched predictive build.

    Equivalent per series to ``predict_mvn(models[s], forecast_dates)``
    but assembled as one S x P row-flattened call (one K4 launch for
    K(x, x) on the card; with ``mesh``, one a shard).  Returns one mixture
    per series.
    """
    models = list(models)
    mu, F, w = _panel_predict_rows(models, list(forecast_dates),
                                   include_noise=include_noise, mesh=mesh)
    out = []
    for s in range(len(models)):
        cov = np.einsum("pij,pkj->pik", F[s], F[s])
        out.append(MvNormalMixture(w[s], mu[s], cov))
    return out


def forecast_panel(models, forecast_dates, forecast_draws: int, *,
                   inv_transformations=None, include_noise: bool = True,
                   mesh=None, seed: int | None = None) -> list[np.ndarray]:
    """Sample forecasts for every series of a fitted panel at once.

    The panel analog of :func:`..forecasting.forecast` (no per-draw HMC):
    one batched predictive build + PSD factorization for all S x P rows,
    then per-series mixture draws with numpy, as the JAX package draws
    them.  ``inv_transformations``: one callable shared by all series, or a
    sequence of per-series callables.  Returns a list of ``(n_dates,
    forecast_draws)`` arrays.  ``mesh`` shards the predictive build as in
    ``panel_predict_mvn``.
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

    mu, F, w = _panel_predict_rows(models, dates, include_noise=include_noise,
                                   mesh=mesh)
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        comps = rng.choice(w.shape[1], size=n_draws, p=w[s])
        eps = rng.standard_normal((n_draws, nq))
        # (n_draws, nq): mu[comp] + F[comp] @ eps  per draw
        draws = mu[s][comps] + np.einsum("dij,dj->di", F[s][comps], eps)
        out.append(apply_elementwise(invs[s], draws.T))
    return out
