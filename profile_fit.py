#!/usr/bin/env python3
"""Split one of ``chip_smoke.py``'s fits into device kernels and host phases.

    python3 profile_fit.py daily     # phase 4's fit (daily_200p, seed 2)
    python3 profile_fit.py weekly    # phase 3's fit (bench.py, seed 2)
    python3 profile_fit.py pallas    # phase 5's: phase 3's fit under both
                                     # "pallas" backends (K7F/K7B, K6a/K6b)
    python3 profile_fit.py panel     # phase 7's fit_panel (20 series x 24
                                     # particles, device engine, seed 1)

Builds the kernel library as ``chip_smoke.py`` does, then runs the fit on
one NVIDIA card: three times unprofiled (``fit_s`` is their median, since
single fits spread widely); under ``torch.profiler`` with CUDA activity only
(device time by kernel: the 16 largest, and every launch of the port's
own kernels); and with synchronised host timers around its
phases (structure proposals, HMC, proposal LMLs, reweights; for the panel,
the device proposals' tree surgery, HMC and the reweights).
The timers wrap the functions the fit looks up in its modules; a phase
whose timer never fired is an error, so a renamed call site cannot leave
a split that silently misses a phase.  Prints one JSON object, then the
``nvidia-smi`` name/power line.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs


def _timed(timers, key, fn):
    def wrapper(*a, **k):
        cs._sync()
        t = time.time()
        r = fn(*a, **k)
        cs._sync()
        timers[key] = timers.get(key, 0.0) + time.time() - t
        return r
    return wrapper


def profile_fit(path, seed=2, n_particles=200):
    import torch

    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch.inference import device_smc, structure_mcmc
    from nowcastautogp_tpu_torch.models import gp_model
    from nowcastautogp_tpu_torch.ops import cov, lml
    from nowcastautogp_tpu_torch.parallel import panel

    if path == "weekly":
        data = cs._weekly_data(ngp, seed, 150, 160)[2]

        def fit():
            cs._weekly_fit(ngp, data, seed, n_particles)
    elif path == "pallas":
        data = cs._weekly_data(ngp, seed, 150, 160)[2]

        def fit():
            saved = lml._LML_BACKEND, cov._COV_BACKEND
            lml.set_lml_backend("pallas")
            cov.set_cov_backend("pallas")
            try:
                cs._weekly_fit(ngp, data, seed, n_particles)
            finally:
                lml.set_lml_backend(saved[0])
                cov.set_cov_backend(saved[1])
    elif path == "daily":
        data = cs._daily_data(ngp, seed, 560, 28)[2]

        def fit():
            cs._daily_fit(ngp, data, seed, n_particles)
    elif path == "panel":
        import bench_torch

        datasets = bench_torch.panel_workload()[1]
        kw = bench_torch.panel_fit_kwargs()

        def fit():
            ngp.fit_panel(datasets, seed=1, engine="device", device=cs.DEVICE,
                          **kw)
    else:
        raise cs.SmokeFailure(
            f"takes weekly, daily, pallas or panel, not {path!r}")
    out = {"path": path, "fits_s": []}
    for _ in range(3):
        cs._sync()
        t0 = time.time()
        fit()
        cs._sync()
        out["fits_s"].append(time.time() - t0)
    out["fit_s"] = sorted(out["fits_s"])[1]

    t0 = time.time()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fit()
        cs._sync()
    out["fit_profiled_s"] = time.time() - t0
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    out["device_s"] = sum(e.device_time_total for e in rows) / 1e6
    out["kernels"] = [
        {"name": e.key[:80], "calls": e.count,
         "device_s": e.device_time_total / 1e6} for e in rows[:16]]
    # every launch of the port's own kernels (csrc/, each in the global
    # unnamed namespace), however small: a kernel's device time is their sum
    out["port_kernels"] = [
        {"name": e.key[:80], "calls": e.count,
         "device_s": e.device_time_total / 1e6} for e in rows
        if e.key.removeprefix("void ").startswith("(anonymous namespace)::")]

    timers = {}
    patches = [(structure_mcmc, "propose_batch", "propose_batch"),
               (structure_mcmc, "run_hmc", "hmc"),
               (structure_mcmc, "gp_lml_batched", "proposal_lml"),
               (gp_model, "gp_lml_batched", "reweight_lml")]
    if path == "panel":
        patches = [(device_smc, "device_propose_mixed", "propose_device"),
                   (device_smc, "run_hmc", "hmc"),
                   (panel, "gp_lml_batched", "reweight_lml")]
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for m, a, key in patches:
        setattr(m, a, _timed(timers, key, getattr(m, a)))
    try:
        t0 = time.time()
        fit()
        cs._sync()
        out["fit_timed_s"] = time.time() - t0
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    missing = [key for _, _, key in patches if key not in timers]
    cs.check(not missing, f"the fit never called the timed phases {missing}")
    out["phases_s"] = timers
    return out


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else ""
    smi = cs.setup()
    print(json.dumps({"profile": profile_fit(path)}))
    print(smi)


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeFailure as e:
        cs.log(f"profile_fit: FAILED: {e}")
        sys.exit(1)
