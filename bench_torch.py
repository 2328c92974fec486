#!/usr/bin/env python3
"""bench.py's workload and quality gates on the PyTorch port, on one card.

    python3 bench_torch.py [--engine host|device]

The workload of ``bench.py:46-100`` at its operating point, through the
port's entry points: a 200-particle depth-5 ensemble fitted by
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
the card's ``nvidia-smi`` name and power limit, then one JSON line; exits
1 when a gate fails, 2 when torch sees no CUDA device.  Imports nothing of
jax or the JAX package.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("host", "device"), default="host")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

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
    print(smi)
    print(json.dumps({
        "engine": args.engine, "warmup_s": warmup_s, "runs": runs,
        **medians, "log_crps": log_crps, "coverage90": coverage90,
        "cp_family_log_crps_median": cp_median, "gates": gates,
        "gate_max_log_crps": GATE_MAX_LOG_CRPS,
        "gate_coverage90": list(GATE_COVERAGE90),
        "gate2_max_median_log_crps": GATE2_MAX_MEDIAN_LOG_CRPS,
        "quality_gate_ok": all(gates.values()), "device": smi}))
    if not all(gates.values()):
        print(f"QUALITY GATE FAILED: {gates}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
