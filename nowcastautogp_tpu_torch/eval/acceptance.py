"""The getting-started acceptance workflow as library code.

Port of the JAX package's ``eval/acceptance.py``: the same approaches,
vintage, data preparation and scores (numpy), with the fits and forecasts
on the port's entry points (``fit_kwargs`` take ``device``; the card by
default).  Like the JAX package it reproduces the reference's
executed-vignette acceptance pipeline
(``docs/vignettes/getting-started.jl``): fit on confirmed
(redacted) vintaged data per report date (canonical budgets at
``:266-268``), forecast with five approaches (naive / leave-out-last /
nowcast / nowcast+HMC / nowcast+forecast-HMC, ``:399-633``), and score with
mean log-scale CRPS over a 4-week horizon (``:689-786``), reporting ratios
against the nowcast+HMC baseline (``:817-819``).

The reference repo does not ship its NHSN vintage CSV nor a numeric CRPS
table (figures only), so the JAX package's committed acceptance artifact
(ACCEPTANCE.md) runs this workflow on a synthetic vintage with the vignette's own revision
model: the most recent week is under-reported by a LogNormal(0.1, 0.027)
factor (the MLE the vignette fits at ``:553-556``), older weeks are final.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from ..fitting import make_and_fit_model
from ..forecasting import forecast
from ..models.gp_model import GPModel
from ..nowcast import create_nowcast_data, forecast_with_nowcasts
from ..tdata import create_transformed_data
from ..transforms import get_transformations
from ..utils.data import VintagedData
from .crps import crps_ensemble
from .wis import wis_ensemble

__all__ = ["synthetic_nhsn_vintage", "fit_on_data", "fit_on_data_panel",
           "score_forecast", "score_forecast_wis", "run_acceptance",
           "APPROACHES"]

APPROACHES = ("naive", "leave_out_last", "nowcast", "nowcast_hmc",
              "nowcast_forecast_hmc")


def synthetic_nhsn_vintage(n_weeks: int = 150, seed: int = 0,
                           log_mean: float = 0.1, log_sd: float = 0.027,
                           process_noise: float = 0.05,
                           start=_dt.date(2022, 1, 3)) -> VintagedData:
    """NHSN-like weekly hospitalization vintage with last-week under-reporting.

    Truth: seasonal + trend log-signal with multiplicative noise (the shape
    of the vignette's COVID NHSN series).  Revision model: at report date r,
    the week t == r is under-reported by ``exp(log_mean + log_sd * Z)``
    (i.e. eventual/reported ~ LogNormal, ``getting-started.jl:553-556``);
    weeks t < r are final.

    Low process noise keeps the most recent (under-reported) point genuinely
    load-bearing for the forecast — the regime where naively trusting
    provisional data fails, as in the reference's NHSN series.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_weeks)
    truth = 800 * np.exp(
        0.35 * np.sin(2 * np.pi * t / 52)
        + 0.25 * np.sin(2 * np.pi * t / 26 + 1.0)
        - 0.003 * t
        + process_noise * rng.standard_normal(n_weeks)
    )
    final = np.maximum(truth, 1.0)
    dates = [start + _dt.timedelta(weeks=int(i)) for i in range(n_weeks)]
    refs, reps, vals = [], [], []
    for r in range(n_weeks):
        # snapshot at report r: weeks 0..r known; week r provisional
        factor = float(np.exp(log_mean + log_sd * rng.standard_normal()))
        for s in range(r + 1):
            refs.append(dates[s])
            reps.append(dates[r])
            vals.append(final[s] / factor if s == r else final[s])
    return VintagedData(refs, reps, vals)


def _prepare_fit(vintage: VintagedData, report_date, *, n_redact: int = 1,
                 max_ahead: int = 8) -> dict:
    """Snapshot + transform + redact for one report date (the data half of
    the vignette's per-report-date fit, ``getting-started.jl:261-284``)."""
    ds_all, vals_all = vintage.snapshot(report_date)
    transformation, inv_transformation = get_transformations(
        "boxcox", vals_all)
    data = create_transformed_data(
        ds_all[:-n_redact], vals_all[:-n_redact],
        transformation=transformation)
    last = ds_all[-1]
    last = last if isinstance(last, _dt.date) else last.astype(
        "datetime64[D]").astype(_dt.date)
    forecast_dates = [last + _dt.timedelta(weeks=k)
                      for k in range(0, max_ahead + 1)]
    return {
        "data": data,
        "forecast_dates": forecast_dates,
        "transformation": transformation,
        "inv_transformation": inv_transformation,
        "revise_dates": list(ds_all[-n_redact:]),
        "revise_values": np.asarray(vals_all[-n_redact:]),
    }


def fit_on_data(vintage: VintagedData, report_date, *, n_redact: int = 1,
                max_ahead: int = 8, n_particles: int = 24,
                smc_data_proportion: float = 0.1, n_mcmc: int = 50,
                n_hmc: int = 50, seed: int | None = None, **fit_kwargs):
    """The vignette's per-report-date fit (``getting-started.jl:261-294``).

    Returns a dict with the fitted model state, forecast dates, the
    transformation pair, and the still-provisional data to revise.
    """
    fitted = _prepare_fit(vintage, report_date, n_redact=n_redact,
                          max_ahead=max_ahead)
    model = make_and_fit_model(
        fitted.pop("data"), n_particles=n_particles,
        smc_data_proportion=smc_data_proportion, n_mcmc=n_mcmc, n_hmc=n_hmc,
        seed=seed, **fit_kwargs)
    fitted["model_dict"] = model.to_dict()
    return fitted


def fit_on_data_panel(vintage: VintagedData, report_dates, *,
                      n_redact: int = 1, max_ahead: int = 8,
                      n_particles: int = 24,
                      smc_data_proportion: float = 0.1, n_mcmc: int = 50,
                      n_hmc: int = 50, seed: int | None = None,
                      **fit_kwargs) -> list[dict]:
    """All report dates' fits as ONE panel program.

    The reference maps over report dates serially
    (``getting-started.jl:377-391``); here the redacted per-date series
    become rows of a single flattened ``n_dates x n_particles`` SMC
    program (``parallel.fit_panel``: heterogeneous lengths via per-row
    masks, per-date Box-Cox transformations preserved), so the whole
    acceptance workflow's fit cost is one batched chain instead of
    ``n_dates`` sequential ones.  Statistically each date still gets an
    independently initialized ensemble annealed on its own data.

    Returns the same per-date ``fitted`` dicts as :func:`fit_on_data`.
    """
    from ..parallel.panel import fit_panel

    prepared = [_prepare_fit(vintage, rd, n_redact=n_redact,
                             max_ahead=max_ahead) for rd in report_dates]
    models = fit_panel(
        [p["data"] for p in prepared], n_particles=n_particles,
        smc_data_proportion=smc_data_proportion, n_mcmc=n_mcmc,
        n_hmc=n_hmc, seed=seed, **fit_kwargs)
    out = []
    for p, model in zip(prepared, models):
        p.pop("data")
        p["model_dict"] = model.to_dict()
        out.append(p)
    return out


def score_forecast(vintage: VintagedData, forecast_dates, forecasts,
                   *, max_horizon: int = 4) -> float:
    """Mean log-scale CRPS over the first ``max_horizon`` forecast dates
    against final values (``getting-started.jl:705-718``, with
    ``data_transform = log``)."""
    score_dates = list(forecast_dates)[:max_horizon]
    finals = vintage.final(score_dates)
    total = 0.0
    for h in range(max_horizon):
        total += crps_ensemble(
            np.log(np.maximum(forecasts[h], 1e-9)), float(np.log(finals[h]))
        )
    return total / max_horizon


def score_forecast_wis(vintage: VintagedData, forecast_dates, forecasts,
                       *, max_horizon: int = 4) -> float:
    """Mean log-scale WIS over the first ``max_horizon`` forecast dates —
    the same comparison as :func:`score_forecast` in the CDC hubs'
    submission-format scoring rule (FluSight 23-quantile grid)."""
    score_dates = list(forecast_dates)[:max_horizon]
    finals = vintage.final(score_dates)
    total = 0.0
    for h in range(max_horizon):
        total += wis_ensemble(
            np.log(np.maximum(forecasts[h], 1e-9)), float(np.log(finals[h]))
        )
    return total / max_horizon


def _forecasts_for(fitted, approach: str, *, n_forecasts: int,
                   n_nowcast_samples: int, rng: np.random.Generator,
                   log_mean: float = 0.1, log_sd: float = 0.027):
    """One approach's (n_dates, n_forecasts) matrix (vignette :399-633)."""
    model = GPModel(fitted["model_dict"])
    fdates = fitted["forecast_dates"]
    inv = fitted["inv_transformation"]
    tr = fitted["transformation"]
    if approach == "leave_out_last":
        return forecast(model, fdates, n_forecasts, inv_transformation=inv)
    if approach == "naive":
        ncs = create_nowcast_data(
            [fitted["revise_values"]], fitted["revise_dates"],
            transformation=tr)
        return forecast_with_nowcasts(
            model, ncs, fdates, n_forecasts, inv_transformation=inv,
            ess_threshold=1.0)
    # nowcast approaches: LogNormal reporting-factor draws on the last week
    samples = [
        fitted["revise_values"]
        * np.exp(log_mean + rng.standard_normal() * log_sd)
        for _ in range(n_nowcast_samples)
    ]
    ncs = create_nowcast_data(samples, fitted["revise_dates"],
                              transformation=tr)
    draws_per = n_forecasts // n_nowcast_samples
    if approach == "nowcast":
        return forecast_with_nowcasts(
            model, ncs, fdates, draws_per, inv_transformation=inv)
    if approach == "nowcast_hmc":
        return forecast_with_nowcasts(
            model, ncs, fdates, draws_per, inv_transformation=inv, n_hmc=1)
    if approach == "nowcast_forecast_hmc":
        return forecast_with_nowcasts(
            model, ncs, fdates, draws_per, inv_transformation=inv,
            forecast_n_hmc=1)
    raise AssertionError(f"unknown approach {approach!r}")


def run_acceptance(vintage: VintagedData | None = None, *,
                   report_dates=None, n_forecasts: int = 2000,
                   n_nowcast_samples: int = 100, max_horizon: int = 4,
                   log_mean: float = 0.1, log_sd: float = 0.027,
                   seed: int = 0, verbose: bool = False, panel: bool = True,
                   **fit_kwargs):
    """Run the five-approach CRPS comparison; returns a results dict.

    ``fit_kwargs`` override the canonical budgets (n_particles=24,
    smc_data_proportion=0.1, n_mcmc=50, n_hmc=50) for fast/smoke runs, and
    pass through to the fit (``device``, ``engine``, ...).

    ``panel=True`` (default) fits ALL report dates as one flattened
    ``n_dates x n_particles`` SMC program (:func:`fit_on_data_panel`);
    ``panel=False`` keeps the reference-shaped serial per-date fits.

    Result: {"scores": {approach: mean CRPS}, "ratios": {approach: score /
    nowcast_hmc score}, "per_report": {...}} — ratios mirror the vignette's
    bar chart (baseline = nowcast_hmc, ``getting-started.jl:817-819``) —
    plus the same comparison under WIS ("scores_wis" / "ratios_wis",
    FluSight quantile grid) so both scoring rules are on record.
    """
    import logging

    log = logging.getLogger("nowcastautogp_tpu_torch")
    if vintage is None:
        vintage = synthetic_nhsn_vintage()
    if report_dates is None:
        # every 12th report date in the second half of the vintage
        rds = list(vintage.report_date_range())
        report_dates = rds[len(rds) // 2::12]
    report_dates = list(report_dates)  # a generator would exhaust in the loop
    rng = np.random.default_rng(seed)
    per_report: dict[str, list[float]] = {a: [] for a in APPROACHES}
    per_report_wis: dict[str, list[float]] = {a: [] for a in APPROACHES}
    if panel and len(report_dates) > 1:
        fitted_all = fit_on_data_panel(
            vintage, report_dates, seed=seed + 1000, **fit_kwargs)
    else:
        fitted_all = None
    for i, rd in enumerate(report_dates):
        fitted = (fitted_all[i] if fitted_all is not None else
                  fit_on_data(vintage, rd, seed=seed + 1000 + i,
                              **fit_kwargs))
        for approach in APPROACHES:
            fc = _forecasts_for(
                fitted, approach, n_forecasts=n_forecasts,
                n_nowcast_samples=n_nowcast_samples, rng=rng,
                log_mean=log_mean, log_sd=log_sd)
            s = score_forecast(vintage, fitted["forecast_dates"], fc,
                               max_horizon=max_horizon)
            per_report[approach].append(s)
            per_report_wis[approach].append(score_forecast_wis(
                vintage, fitted["forecast_dates"], fc,
                max_horizon=max_horizon))
            if verbose:
                log.info("report %d/%d %s: CRPS %.4f",
                         i + 1, len(report_dates), approach, s)
    scores = {a: float(np.mean(v)) for a, v in per_report.items()}
    base = scores["nowcast_hmc"]
    ratios = {a: float(s / base) for a, s in scores.items()}
    scores_wis = {a: float(np.mean(v)) for a, v in per_report_wis.items()}
    base_wis = scores_wis["nowcast_hmc"]
    ratios_wis = {a: float(s / base_wis) for a, s in scores_wis.items()}
    return {"scores": scores, "ratios": ratios, "per_report": per_report,
            "scores_wis": scores_wis, "ratios_wis": ratios_wis,
            "n_report_dates": len(report_dates)}
