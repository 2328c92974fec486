#!/usr/bin/env python3
"""bench.py's workload and quality gates on the PyTorch port, on one card.

    python3 bench_torch.py [--engine host|device]
    python3 bench_torch.py --panel [--serial] [--mesh]
    python3 bench_torch.py --acceptance [--full]

Default mode: the workload of ``bench.py:46-100`` at its operating point,
through the port's entry points: a 200-particle depth-5 ensemble fitted by
data-annealed SMC on a 150-week series (14 structure moves x 5 HMC x 5
leapfrog per step, schedule proportion 0.1), then a 100-scenario x
20-draw nowcast-conditioned forecast of the 8 weeks after the two nowcast
weeks (``ess_threshold=0.5``), scored by log-CRPS and 90% interval
coverage against the held-out truth.  One warm-up run at seed 1, then
seeds 2, 3 and 4 on the nhsn-like family and on ``outbreak_cp`` (the
port's own ``eval/families.py``).

The gates are ``bench.py:108-118``'s, with its numbers and rounding: the
mean log-CRPS of the nhsn seeds at most 0.105, their mean coverage90 in
[0.70, 1.0], and the median log-CRPS of the ``outbreak_cp`` seeds at most
0.45.  Prints each run's fit and forecast seconds and scores, the medians,
the fit's operations and MFU on the H100's peaks at the median nhsn fit
time (``utils/flops.py``, as ``bench.py:209-222`` prints XLA's), the
card's ``nvidia-smi`` name and power limit, then one JSON line; exits 1
when a gate fails, 2 when torch sees no CUDA device.  Imports nothing of
jax or the JAX package.

``--panel``: the JAX package's ``tools/panel_bench.py`` workload on the
port -- S = 20 nhsn-like series x 150 weeks (one Box-Cox transformation
each), 24 particles each (480 rows), 14 x 5 x 5 moves per step at
proportion 0.1, ``fit_panel(engine="device")`` at seed 1, then
``forecast_panel`` of 8 weeks x 500 draws per series at seed 2; each
series' log-CRPS must stay under that tool's collapse gate of 0.2 (exit 1
otherwise).  ``--serial`` adds the same 20 series fitted one by one
through ``make_and_fit_model`` at identical budgets (the device engine,
seeds 1000 + s) and forecast with ``forecast``: both fit times and both
per-series log-CRPS medians.  ``--mesh`` shards the panel's rows over
every visible card (``make_mesh()``).  Both print each fit's MFU.

``--acceptance``: ``run_acceptance`` (the five-approach CRPS comparison of
the JAX package's ``examples/acceptance.py``) with the panel fit, on the
harsh revision regime (``log_mean=0.25, log_sd=0.10``) at 4 report dates:
by default that example's reduced budget (120 weeks, 8 particles,
proportion 0.2, ``n_mcmc=8, n_hmc=4``, 200 forecasts, 20 nowcasts);
``--full`` the vignette's canonical budgets (150 weeks, 24 particles,
proportion 0.1, ``n_mcmc=50, n_hmc=50``, 2,000 forecasts, 100
nowcasts).  Prints the scores, ratios, the wall-clock and whether the
headline ordering holds (the best nowcast variant below both
leave-out-last and naive, the JAX package's
``tests/test_acceptance_artifact.py``), reported as measured, never
gated.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_MCMC, N_HMC, N_LEAPFROG = 14, 5, 5
SEEDS = (2, 3, 4)
GATE_MAX_LOG_CRPS = 0.105
GATE_COVERAGE90 = (0.70, 1.0)
GATE2_FAMILY = "outbreak_cp"
GATE2_MAX_MEDIAN_LOG_CRPS = 0.45


def _series(n, seed, family):
    from nowcastautogp_tpu_torch.eval.families import nhsn_like, outbreak_cp

    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    gen = outbreak_cp if family == "outbreak_cp" else nhsn_like
    return dates, gen(n, seed)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(seed, family="nhsn", *, n_particles=200, n_train=150,
        n_scenarios=100, draws_per=20, horizon=8, engine="host",
        device="cuda"):
    """One fit and nowcast forecast; returns (fit_s, forecast_s, log_crps,
    coverage90), the scores unrounded."""
    import nowcastautogp_tpu_torch as ngp

    dates, obs = _series(n_train + 2 + horizon, seed, family)
    fwd, inv = ngp.get_transformations("boxcox", obs[:n_train])
    data = ngp.create_transformed_data(dates[:n_train], obs[:n_train],
                                       transformation=fwd)
    _sync(device)
    t0 = time.time()
    model = ngp.make_and_fit_model(
        data, n_particles=n_particles, smc_data_proportion=0.1,
        n_mcmc=N_MCMC, n_hmc=N_HMC, seed=seed,
        config=ngp.GPConfig(max_depth=5),
        hmc_config=ngp.HMCConfig(n_leapfrog=N_LEAPFROG), engine=engine,
        device=device)
    _sync(device)
    fit_s = time.time() - t0

    # nowcast scenarios: the last two weeks still being revised
    rng = np.random.default_rng(seed + 1)
    nc_dates = dates[n_train:n_train + 2]
    nc_draws = obs[n_train:n_train + 2] * rng.lognormal(
        0.1, 0.027, size=(n_scenarios, 2))
    ncs = ngp.create_nowcast_data(list(nc_draws), nc_dates,
                                  transformation=fwd)
    f_dates = [nc_dates[-1] + dt.timedelta(weeks=i + 1)
               for i in range(horizon)]
    t0 = time.time()
    fc = ngp.forecast_with_nowcasts(model, ncs, f_dates, draws_per,
                                    inv_transformation=inv,
                                    ess_threshold=0.5)
    _sync(device)
    forecast_s = time.time() - t0
    if fc.shape != (horizon, n_scenarios * draws_per):
        raise RuntimeError(f"forecast shape {fc.shape}")
    if not (np.all(np.isfinite(fc)) and np.all(fc >= 0)):
        raise RuntimeError("forecast has non-finite or negative draws")
    truth = obs[n_train + 2:n_train + 2 + horizon]
    crps = float(ngp.crps_matrix(np.log(np.maximum(fc, 1e-9)),
                                 np.log(truth)).mean())
    q = ngp.quantile_matrix_device(fc, [0.05, 0.95], device=device)
    cover90 = float(np.mean((truth >= q[0]) & (truth <= q[1])))
    return fit_s, forecast_s, crps, cover90


# ---------------------------------------------------------------- --panel

PANEL_GATE_MAX_LOG_CRPS = 0.2


def panel_workload(S=20, n=150, horizon=8):
    """``tools/panel_bench.py``'s panel: S nhsn-like series (seeds 100 + s,
    scaled by 0.5 + 0.1 s), each with its own Box-Cox transformation.
    Returns (dates, datasets, inverse transformations, held-out truths)."""
    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch.eval.families import nhsn_like

    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i)
             for i in range(n + horizon)]
    datasets, invs, truths = [], [], []
    for s in range(S):
        obs = nhsn_like(n + horizon, 100 + s) * (0.5 + 0.1 * s)
        fwd, inv = ngp.get_transformations("boxcox", obs[:n])
        datasets.append(ngp.create_transformed_data(
            dates[:n], obs[:n], transformation=fwd))
        invs.append(inv)
        truths.append(obs[n:])
    return dates, datasets, invs, truths


def panel_fit_kwargs():
    """The panel's fit budget (``tools/panel_bench.py``): 24 particles,
    depth 5, 14 moves x 5 HMC x 5 leapfrog per step, proportion 0.1."""
    import nowcastautogp_tpu_torch as ngp

    return dict(n_particles=24, smc_data_proportion=0.1, n_mcmc=N_MCMC,
                n_hmc=N_HMC, config=ngp.GPConfig(max_depth=5),
                hmc_config=ngp.HMCConfig(n_leapfrog=N_LEAPFROG))


def score_series(fcs, truths, device):
    """Per-series log-CRPS and 90% coverage of forecast matrices."""
    import nowcastautogp_tpu_torch as ngp

    crps, cover = [], []
    for fc, truth in zip(fcs, truths):
        crps.append(float(ngp.crps_matrix(
            np.log(np.maximum(fc, 1e-9)), np.log(truth)).mean()))
        q = ngp.quantile_matrix_device(fc, [0.05, 0.95], device=device)
        cover.append(float(np.mean((truth >= q[0]) & (truth <= q[1]))))
    return crps, cover


def fit_mfu(config, n_rows, n_train, proportion, fit_s, types=None):
    """``utils/flops``' operations and MFU of a fit at ``bench.py``'s move
    budget (14 x 5 x 5) over ``n_rows`` rows of ``n_train`` points."""
    from nowcastautogp_tpu_torch.inference.schedule import linear_schedule
    from nowcastautogp_tpu_torch.models.gp_model import _PAD
    from nowcastautogp_tpu_torch.utils.flops import fit_cost_analysis, mfu

    ops, _ = fit_cost_analysis(
        P=n_rows, config=config,
        schedule=linear_schedule(n_train, max(proportion, 1.0 / n_train)),
        cap_full=max(64, -(-n_train // _PAD) * _PAD), n_mcmc=N_MCMC,
        n_hmc=N_HMC, n_leapfrog=N_LEAPFROG, types=types)
    return mfu(ops, fit_s)


def run_panel(serial=False, draws=500, device="cuda", mesh=None):
    import nowcastautogp_tpu_torch as ngp

    dates, datasets, invs, truths = panel_workload()
    f_dates = dates[len(datasets[0].y):]
    kw = panel_fit_kwargs()
    _sync(device)
    t0 = time.time()
    models = ngp.fit_panel(datasets, seed=1, engine="device", device=device,
                           mesh=mesh, **kw)
    _sync(device)
    fit_s = time.time() - t0
    t0 = time.time()
    fcs = ngp.forecast_panel(models, f_dates, draws,
                             inv_transformations=invs, seed=2, mesh=mesh)
    forecast_s = time.time() - t0
    crps, cover = score_series(fcs, truths, device)
    out = {"panel": {
        "fit_s": fit_s, "forecast_s": forecast_s,
        "log_crps_per_series": crps,
        "log_crps_median": float(np.median(crps)),
        "coverage90_mean": float(np.mean(cover)),
        "shards": mesh.size if mesh is not None else 1,
        "mfu": fit_mfu(kw["config"], len(datasets) * kw["n_particles"],
                       len(datasets[0].y), kw["smc_data_proportion"], fit_s,
                       np.concatenate([m._host_types for m in models])),
        "gate_ok": all(np.isfinite(c) and c <= PANEL_GATE_MAX_LOG_CRPS
                       for c in crps)}}
    print(f"panel: fit {fit_s:.3f} s, forecast {forecast_s:.3f} s, "
          f"log-CRPS median {out['panel']['log_crps_median']!r}, MFU "
          f"{json.dumps(out['panel']['mfu'])}", flush=True)
    if serial:
        del models
        _sync(device)
        t0 = time.time()
        smodels = [ngp.make_and_fit_model(d, seed=1000 + i, engine="device",
                                          device=device, **kw)
                   for i, d in enumerate(datasets)]
        _sync(device)
        sfit_s = time.time() - t0
        t0 = time.time()
        sfcs = [ngp.forecast(m, f_dates, draws, inv_transformation=inv)
                for m, inv in zip(smodels, invs)]
        sforecast_s = time.time() - t0
        scrps, scover = score_series(sfcs, truths, device)
        out["serial"] = {
            "fit_s": sfit_s, "forecast_s": sforecast_s,
            "log_crps_per_series": scrps,
            "log_crps_median": float(np.median(scrps)),
            "coverage90_mean": float(np.mean(scover))}
        out["panel_speedup_fit"] = sfit_s / fit_s
        print(f"serial: fit {sfit_s:.3f} s, forecast {sforecast_s:.3f} s, "
              f"log-CRPS median {out['serial']['log_crps_median']!r}; "
              f"panel fit speedup {out['panel_speedup_fit']:.3f}",
              flush=True)
    return out


# ----------------------------------------------------------- --acceptance

HARSH = dict(log_mean=0.25, log_sd=0.10)


def acceptance_budget(full=False, n_report_dates=4):
    """``examples/acceptance.py``'s budgets and report dates (harsh
    regime): (vintage, report dates, run_acceptance keyword arguments)."""
    import nowcastautogp_tpu_torch as ngp

    if full:
        fit_kw = dict(n_particles=24, smc_data_proportion=0.1, n_mcmc=50,
                      n_hmc=50)
        n_forecasts, n_nowcast, n_weeks = 2000, 100, 150
    else:
        fit_kw = dict(n_particles=8, smc_data_proportion=0.2, n_mcmc=8,
                      n_hmc=4)
        n_forecasts, n_nowcast, n_weeks = 200, 20, 120
    vintage = ngp.synthetic_nhsn_vintage(n_weeks, seed=0, **HARSH)
    rds = list(vintage.report_date_range())
    lo = int(len(rds) * 0.6)
    step = max((len(rds) - lo - 5) // max(n_report_dates, 1), 1)
    report_dates = rds[lo:len(rds) - 5:step][:n_report_dates]
    return vintage, report_dates, dict(
        n_forecasts=n_forecasts, n_nowcast_samples=n_nowcast, seed=0,
        panel=True, **HARSH, **fit_kw)


def ordering(scores):
    """The JAX package's headline ordering: the best nowcast variant below
    both leave-out-last and naive."""
    best = min(scores["nowcast"], scores["nowcast_hmc"],
               scores["nowcast_forecast_hmc"])
    return bool(best < scores["leave_out_last"] and best < scores["naive"])


def run_acceptance_mode(full=False, device="cuda"):
    import nowcastautogp_tpu_torch as ngp

    vintage, report_dates, kw = acceptance_budget(full)
    _sync(device)
    t0 = time.time()
    res = ngp.run_acceptance(vintage, report_dates=report_dates,
                             device=device, **kw)
    _sync(device)
    res["wallclock_s"] = time.time() - t0
    res["ordering_reproduced"] = ordering(res["scores"])
    res["ordering_reproduced_wis"] = ordering(res["scores_wis"])
    res["budget"] = dict(kw)
    res["report_dates"] = [str(d) for d in report_dates]
    for key in ("scores", "ratios", "scores_wis", "ratios_wis"):
        print(f"{key}: {json.dumps(res[key])}", flush=True)
    print(f"wall-clock {res['wallclock_s']:.3f} s; headline ordering "
          f"reproduced: CRPS {res['ordering_reproduced']}, WIS "
          f"{res['ordering_reproduced_wis']}", flush=True)
    return res


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("host", "device"), default="host")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--panel", action="store_true")
    mode.add_argument("--acceptance", action="store_true")
    ap.add_argument("--serial", action="store_true",
                    help="--panel: also fit the series one by one")
    ap.add_argument("--mesh", action="store_true",
                    help="--panel: shard the rows over every visible card")
    ap.add_argument("--full", action="store_true",
                    help="--acceptance: the vignette's canonical budgets")
    args = ap.parse_args(argv)
    if ((args.serial or args.mesh) and not args.panel
            or args.full and not args.acceptance):
        ap.error("--serial and --mesh go with --panel, --full with "
                 "--acceptance")

    import torch

    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _smi()
    if args.panel or args.acceptance:
        from nowcastautogp_tpu_torch.ops import cudalib

        t0 = time.time()
        cudalib.build_library()
        build_s = time.time() - t0
        if args.panel:
            import nowcastautogp_tpu_torch as ngp

            mesh = ngp.make_mesh() if args.mesh else None
            out = run_panel(args.serial, mesh=mesh)
        else:
            out = run_acceptance_mode(args.full)
        print(smi)
        print(json.dumps({"mode": "panel" if args.panel else "acceptance",
                          "build_s": build_s, **out, "device": smi}))
        if args.panel and not out["panel"]["gate_ok"]:
            print("PANEL QUALITY GATE FAILED", file=sys.stderr)
            return 1
        return 0

    t0 = time.time()
    run(1, engine=args.engine)                     # builds the kernels
    warmup_s = time.time() - t0
    runs = []
    for family in ("nhsn", GATE2_FAMILY):
        for seed in SEEDS:
            fit_s, fc_s, crps, cover = run(seed, family, engine=args.engine)
            runs.append({"family": family, "seed": seed, "fit_s": fit_s,
                         "forecast_s": fc_s, "log_crps": crps,
                         "coverage90": cover})
            print(f"{family} seed {seed}: fit {fit_s:.3f} s, forecast "
                  f"{fc_s:.3f} s, log-CRPS {crps!r}, coverage90 {cover!r}",
                  flush=True)

    nhsn = [r for r in runs if r["family"] == "nhsn"]
    cp = [r for r in runs if r["family"] == GATE2_FAMILY]
    # bench.py's rounding: per seed to 4 (CRPS) and 3 (coverage) places,
    # then the mean
    crps_seeds = [round(r["log_crps"], 4) for r in nhsn]
    cover_seeds = [round(r["coverage90"], 3) for r in nhsn]
    log_crps = round(float(np.mean(crps_seeds)), 4)
    coverage90 = round(float(np.mean(cover_seeds)), 3)
    cp_median = float(np.median([round(r["log_crps"], 4) for r in cp]))
    gates = {
        "log_crps": log_crps <= GATE_MAX_LOG_CRPS,
        "coverage90": GATE_COVERAGE90[0] <= coverage90 <= GATE_COVERAGE90[1],
        "cp_median": cp_median <= GATE2_MAX_MEDIAN_LOG_CRPS,
    }
    medians = {f"{family}_{key}_median": float(np.median(
        [r[key] for r in runs if r["family"] == family]))
        for family in ("nhsn", GATE2_FAMILY)
        for key in ("fit_s", "forecast_s")}
    for key, value in medians.items():
        print(f"{key}: {value:.3f}")
    # operations of the fit's LML calls on a sample of the prior's trees
    # (bench.py asks XLA for its program's), at the median nhsn fit time
    import nowcastautogp_tpu_torch as ngp

    mfu_detail = fit_mfu(ngp.GPConfig(max_depth=5), 200, 150, 0.1,
                         medians["nhsn_fit_s_median"])
    print(f"MFU: {json.dumps(mfu_detail)}")
    print(smi)
    print(json.dumps({
        "engine": args.engine, "warmup_s": warmup_s, "runs": runs,
        **medians, "log_crps": log_crps, "coverage90": coverage90,
        "cp_family_log_crps_median": cp_median, "gates": gates,
        "gate_max_log_crps": GATE_MAX_LOG_CRPS,
        "gate_coverage90": list(GATE_COVERAGE90),
        "gate2_max_median_log_crps": GATE2_MAX_MEDIAN_LOG_CRPS,
        "quality_gate_ok": all(gates.values()), **mfu_detail,
        "device": smi}))
    if not all(gates.values()):
        print(f"QUALITY GATE FAILED: {gates}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
