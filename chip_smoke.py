#!/usr/bin/env python3
"""Drive the PyTorch port's fit-and-nowcast path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line):

1. setup: require CUDA, print the card's name and power limit, turn TF32
   off, build the LML kernels (``nowcastautogp_tpu_torch/csrc/megalml.cu``)
   with nvcc and print ptxas's register/spill report to stderr;
2. kernel parity on the card: K2 (value) and K1 (value + gradients) against
   the plain torch version on prior-sampled depth-5 populations and a
   hand-built batch covering all 8 node types, at n in {32, 96, 160} with
   full and partial masks and at n = 512; K1's value bitwise equal to K2's;
   a non-SPD particle is NaN in its own lane only; then ms per evaluation of
   K1, K2 and the plain version at P = 200, n = 160;
3. end to end: the ``bench.py`` workload through the port — a 200-particle
   depth-5 SMC fit on a 150-week series (14 structure moves x 5 HMC x 5
   leapfrog per step) and a 100-scenario x 20-draw nowcast forecast —
   scored by log-CRPS and 90% coverage, with both kernels' launch counts
   taken over that run alone.

Prints a JSON line of per-kernel results, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import datetime as dt
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances of the JAX package's fused-kernel parity tests
# (tests/test_pallas_megalml.py): value, then gradients
VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
GRAD_RTOL, GRAD_ATOL = 3e-3, 3e-3
# how much farther from float64 than float32 plain the kernel may be on a
# particle where float32 plain itself misses the tolerance
ILL_FACTOR = 10.0
# one-seed collapse bound on the end-to-end log-CRPS (bench.py gates the
# three-seed mean at 0.105)
MAX_LOG_CRPS = 0.2


DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ phase 1


def setup():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from nowcastautogp_tpu_torch.ops import megalml

    t0 = time.time()
    _, report = megalml.build_library(verbose=True)
    build_s = time.time() - t0
    log(f"kernel build {build_s:.1f} s; ptxas:")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())
    return smi.splitlines()[0], build_s


# ------------------------------------------------------------------ phase 2


def _population(P, n, seed, n_active=None, depth=5):
    """Prior-sampled particles with shared x = linspace(0, 1, n)."""
    from nowcastautogp_tpu_torch.models.config import GPConfig
    from nowcastautogp_tpu_torch.models.structures import sample_particle

    cfg = GPConfig(max_depth=depth)
    rng = np.random.default_rng(seed)
    ts, ps = zip(*[sample_particle(rng, cfg)[:2] for _ in range(P)])
    return _batch(np.stack(ts), np.stack(ps), rng, n, n_active)


def _hand_batch(n, seed, n_active=None):
    """Depth-5 heaps that together hold all 8 node types."""
    from nowcastautogp_tpu_torch.models import structures as st

    trees = [
        {0: st.CONST}, {0: st.SE}, {0: st.LINEAR}, {0: st.GE},
        {0: st.PERIODIC},
        {0: st.PLUS, 1: st.SE, 2: st.PERIODIC},
        {0: st.TIMES, 1: st.LINEAR, 2: st.GE},
        {0: st.CP, 1: st.SE, 2: st.CONST},
        {0: st.CP, 1: st.PLUS, 2: st.TIMES, 3: st.GE, 4: st.TIMES,
         5: st.SE, 6: st.CONST, 9: st.PERIODIC, 10: st.LINEAR},
        {0: st.PLUS, 1: st.CP, 2: st.PERIODIC, 3: st.TIMES, 4: st.GE,
         7: st.PLUS, 8: st.CONST, 15: st.SE, 16: st.LINEAR},
    ]
    rng = np.random.default_rng(seed)
    types = np.zeros((len(trees), 31), np.int32)
    for i, tree in enumerate(trees):
        for slot, t in tree.items():
            types[i, slot] = t
    params = rng.normal(0.0, 0.5, size=(len(trees), 31, 3)).astype(np.float32)
    params[types == 0] = 0.0
    return _batch(types, params, rng, n, n_active)


def _batch(types, params, rng, n, n_active):
    import torch

    P = types.shape[0]
    n_active = n if n_active is None else n_active
    log_noise = rng.normal(-2.0, 0.3, size=P).astype(np.float32)
    x = np.broadcast_to(np.linspace(0, 1, n, dtype=np.float32), (P, n))
    y = rng.normal(0.0, 1.0, size=(P, n)).astype(np.float32)
    mask = np.broadcast_to((np.arange(n) < n_active).astype(np.float32),
                           (P, n))
    noise = np.exp(log_noise)[:, None] + 1e-5
    diagv = mask * noise + (1.0 - mask)

    def cu(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=DEVICE)

    return (cu(types, torch.int32), cu(params), cu(diagv), cu(mask), cu(x),
            cu(y * mask))


def _plain_value_and_grads(args, dtype):
    """Plain version's core and (dparams, gdiag, alpha) in ``dtype``."""
    import torch

    from nowcastautogp_tpu_torch.ops.megalml import lml_core_plain

    types, params, diagv, mask, x, ym = (
        a.to(dtype) if a.is_floating_point() else a for a in args)
    p, d, y = (t.clone().requires_grad_(True) for t in (params, diagv, ym))
    core = lml_core_plain(types, p, d, mask, x, y)
    ok = torch.isfinite(core)
    gp, gd, gy = torch.autograd.grad(torch.where(ok, core, 0.0).sum(),
                                     (p, d, y))
    return (core.detach(), gp, gd, -gy), ok


def _parity(name, kern, ref32, ref64, ok, rtol, atol):
    """Per-particle parity of kernel outputs against the float64 plain
    version, the reference.

    For each particle, r = max over its entries of |out - ref| / (atol +
    rtol |ref|).  The kernel's r must be at most max(1, ILL_FACTOR x the
    float32 plain version's r): within the tolerance, or, on a particle
    whose float32 plain version itself misses it, of the same order as
    float32 plain.  Random targets with small noise make some prior
    particles ill conditioned (condition numbers 1e3-1e4), and the gradient
    sums n^2 such terms, so float32 cannot meet 3e-3 there.  Returns the
    largest absolute error over particles where float32 plain meets the
    tolerance, and the count of the others.
    """
    import torch

    ratio_k = ratio_p = err = None
    for k, r32, r64 in zip(kern, ref32, ref64):
        k, r32, r64 = (t[ok].double().flatten(1) for t in (k, r32, r64))
        tol = atol + rtol * r64.abs()
        rk = ((k - r64).abs() / tol).amax(1)
        rp = ((r32 - r64).abs() / tol).amax(1)
        e = (k - r64).abs().amax(1)
        ratio_k = rk if ratio_k is None else torch.maximum(ratio_k, rk)
        ratio_p = rp if ratio_p is None else torch.maximum(ratio_p, rp)
        err = e if err is None else torch.maximum(err, e)
    bound = torch.clamp_min(ILL_FACTOR * ratio_p, 1.0)
    worst = int(torch.argmax(ratio_k / bound))
    check(bool((ratio_k <= bound).all()),
          f"{name}: kernel error / tolerance {float(ratio_k[worst]):.3g} "
          f"where float32 plain has {float(ratio_p[worst]):.3g} "
          f"(rtol={rtol} atol={atol}, factor {ILL_FACTOR})")
    well = ratio_p <= 1.0
    return (float(err[well].max()) if well.any() else 0.0), int((~well).sum())


def kernel_parity():
    """Hold K1 and K2 against the plain version; returns max abs errors."""
    import torch

    from nowcastautogp_tpu_torch.ops import megalml

    cases = []
    for n in (32, 96, 160):
        for n_active in (n, n - 19):
            cases.append((f"prior P=200 n={n} active={n_active}",
                          _population(200, n, seed=n + n_active,
                                      n_active=n_active)))
            cases.append((f"hand n={n} active={n_active}",
                          _hand_batch(n, seed=n, n_active=n_active)))
    cases.append(("prior P=8 n=512", _population(8, 512, seed=5)))
    cases.append(("hand n=512 active=480",
                  _hand_batch(512, seed=6, n_active=480)))

    err = {"K1": 0.0, "K2": 0.0}
    for name, args in cases:
        core2 = megalml.megalml_val(*args)
        core1, dp, gd, al = megalml.megalml_vag(*args)
        ref32, ok = _plain_value_and_grads(args, torch.float32)
        ref64, ok64 = _plain_value_and_grads(args, torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(core1.view(torch.int32), core2.view(torch.int32)),
              f"{name}: K1 value is not bitwise equal to K2's")
        check(torch.equal(torch.isfinite(core2), ok),
              f"{name}: kernel and plain disagree on which lanes are finite")
        ok = ok & ok64
        check(bool(ok.any()), f"{name}: no finite lane")
        e2, ill2 = _parity(f"{name} K2 core", (core2[:, None],),
                           (ref32[0][:, None],), (ref64[0][:, None],), ok,
                           VAL_RTOL, VAL_ATOL)
        e1, ill1 = _parity(f"{name} K1 gradients", (dp, gd, al), ref32[1:],
                           ref64[1:], ok, GRAD_RTOL, GRAD_ATOL)
        err["K2"] = max(err["K2"], e2)
        err["K1"] = max(err["K1"], e1, e2)
        log(f"parity ok: {name}: {int(ok.sum())}/{ok.numel()} finite lanes; "
            f"max abs err core {e2:.3g}, gradients {e1:.3g} (ill-conditioned "
            f"lanes: {ill2} for the value, {ill1} for the gradients)")

    # a non-SPD particle: a lone CONST leaf with log-amplitude 100 overflows
    # to inf, so its factorisation is NaN; its neighbours must not change
    args = _population(16, 96, seed=13)
    types, params = args[0].clone(), args[1].clone()
    types[2] = 0
    types[2, 0] = 1
    params[2] = 0.0
    params[2, 0, 0] = 100.0
    broken = (types, params) + args[2:]
    base = megalml.megalml_val(*args)
    for which, core in (("K2", megalml.megalml_val(*broken)),
                        ("K1", megalml.megalml_vag(*broken)[0])):
        check(bool(torch.isnan(core[2])), f"{which}: broken lane is not NaN")
        keep = torch.arange(16, device=DEVICE) != 2
        check(torch.equal(core[keep].view(torch.int32),
                          base[keep].view(torch.int32)),
              f"{which}: the broken lane changed its neighbours")
    log("parity ok: non-SPD particle isolated in K1 and K2")
    return err


def _time_ms(fn, warmup=3, runs=20):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_timing():
    """ms per evaluation at the fit's largest shape, P = 200, n = 160."""
    import torch

    from nowcastautogp_tpu_torch.ops import megalml

    args = _population(200, 160, seed=7)
    return {
        "K1": _time_ms(lambda: megalml.megalml_vag(*args)),
        "K2": _time_ms(lambda: megalml.megalml_val(*args)),
        "plain_vag": _time_ms(
            lambda: _plain_value_and_grads(args, torch.float32)),
        "plain_val": _time_ms(
            lambda: megalml.lml_core_plain(*args)),
    }


# ------------------------------------------------------------------ phase 3


def _series(n, seed):
    """The nhsn-like weekly series of bench.py."""
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    truth = 800 * np.exp(
        0.15 * np.sin(2 * np.pi * t / 52)
        + 0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
        - 0.004 * t
    )
    obs = np.maximum(truth * np.exp(0.12 * rng.standard_normal(n)), 1.0)
    return dates, obs


def end_to_end(seed=2, n_particles=200, n_train=150, n_scenarios=100,
               draws_per=20, horizon=8):
    import torch

    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch.ops import megalml

    dates, obs = _series(n_train + 2 + horizon, seed)
    fwd, inv = ngp.get_transformations("boxcox", obs[:n_train])
    data = ngp.create_transformed_data(dates[:n_train], obs[:n_train],
                                       transformation=fwd)
    rng = np.random.default_rng(seed + 1)
    nc_dates = dates[n_train:n_train + 2]
    nc_draws = obs[n_train:n_train + 2] * rng.lognormal(
        0.1, 0.027, size=(n_scenarios, 2))
    ncs = ngp.create_nowcast_data(list(nc_draws), nc_dates,
                                  transformation=fwd)
    f_dates = [nc_dates[-1] + dt.timedelta(weeks=i + 1)
               for i in range(horizon)]

    megalml.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    model = ngp.make_and_fit_model(
        data, n_particles=n_particles, smc_data_proportion=0.1,
        n_mcmc=14, n_hmc=5, seed=seed, config=ngp.GPConfig(max_depth=5),
        hmc_config=ngp.HMCConfig(n_leapfrog=5), device=DEVICE)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    t0 = time.time()
    fc = ngp.forecast_with_nowcasts(model, ncs, f_dates, draws_per,
                                    inv_transformation=inv, ess_threshold=0.5)
    torch.cuda.synchronize()
    nowcast_s = time.time() - t0
    launches = {"K1": megalml.K1_LAUNCHES, "K2": megalml.K2_LAUNCHES}

    check(fc.shape == (horizon, n_scenarios * draws_per),
          f"forecast shape {fc.shape}")
    check(bool(np.all(np.isfinite(fc)) and np.all(fc >= 0)),
          "forecast has non-finite or negative draws")
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched on the main path")
    truth = obs[n_train + 2:n_train + 2 + horizon]
    crps = float(ngp.crps_matrix(np.log(np.maximum(fc, 1e-9)),
                                 np.log(truth)).mean())
    q = ngp.quantile_matrix_device(fc, [0.05, 0.95], device=DEVICE)
    cover90 = float(np.mean((truth >= q[0]) & (truth <= q[1])))
    check(crps <= MAX_LOG_CRPS, f"log-CRPS {crps:.4f} > {MAX_LOG_CRPS}")
    return {"fit_s": fit_s, "nowcast_s": nowcast_s, "log_crps": crps,
            "coverage90": cover90, "launches": launches}


def main():
    import torch

    smi, build_s = setup()
    err = kernel_parity()
    ms = kernel_timing()
    log(f"ms/eval at P=200 n=160: {json.dumps(ms)}")
    e2e = end_to_end()
    log(f"end to end: {json.dumps(e2e)}")
    src = "nowcastautogp_tpu_torch/csrc/megalml.cu"
    kernels = [
        {"name": "K1 megalml_vag_kernel (LML value + gradient)",
         "route": "cuda", "source": src,
         "replaces": "nowcastautogp_tpu/ops/pallas_megalml.py:428",
         "launches": e2e["launches"]["K1"], "max_abs_err": err["K1"],
         "ms": ms["K1"], "plain_ms": ms["plain_vag"]},
        {"name": "K2 megalml_val_kernel (LML value)",
         "route": "cuda", "source": src,
         "replaces": "nowcastautogp_tpu/ops/pallas_megalml.py:417",
         "launches": e2e["launches"]["K2"], "max_abs_err": err["K2"],
         "ms": ms["K2"], "plain_ms": ms["plain_val"]},
    ]
    print(json.dumps({"build_s": build_s, "kernel_ms_p200_n160": ms,
                      "end_to_end": e2e}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        log(f"chip_smoke: FAILED: {e}")
        sys.exit(1)
