#!/usr/bin/env python3
"""Drive the PyTorch port's fit-and-forecast paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line):

1. setup: require CUDA, print the card's name and power limit, turn TF32
   off, build the kernel library (``nowcastautogp_tpu_torch/csrc/*.cu``,
   one nvcc per source, all at once) and print ptxas's register/spill
   report to stderr;
2. kernel parity on the card, each kernel against its plain torch version
   in float64 (the reference) and float32 under the per-particle rule of
   ``_parity``, at the shapes the main paths give it: K2 (value) and K1
   (value + gradients) on 200 prior-sampled depth-5 particles at every
   capacity the two fits run them at (32 ... 160 weekly, 96 ... 512
   daily), with full and partial masks, and on a hand-built batch covering
   all 8 node types, K1's value bitwise K2's; K4 (covariance), K5 (its
   VJP, asymmetric cotangent) and K3 (L^-1, also through the inverse
   core's value and gradients) on the same kinds of batches at P = 200 and
   n in {96, 160, 576} (160: the nowcast's K(x, x); 576: the daily
   composed step and forecast) and at P = 4, n = 1024, K4/K5 also at
   n = 2048; each of K3/K4/K5 bitwise equal over two launches; K4 bitwise
   equal to K7F's symmetric path (the same tile code) at n = 160 and 512;
   a non-SPD particle NaN in its own K1/K2/K3 lane only; then ms per launch
   of every kernel by the device's clock (20 launches captured in a CUDA
   graph, replayed between events) and one call at a time (``host_ms``),
   and of its plain version over back-to-back calls, at the main paths' shapes
   (K1/K2 at P = 200, n = 160 and 512, each beside its bound and the
   composed core at the same n, its yardstick; K3/K4/K5 at P = 200,
   n = 576, K4/K5 also at n = 160 and 2048 and on the daily fit's own
   heap classes at 576) and K3's library call; then K1 split by kernel
   (the factorisation, the backward walk's launches, the tile sum; by
   ``torch.profiler``, in a process of its own) at P = 200, n = 160 and
   512 on prior and fitted-like heap classes and on the refresh's 20,000
   rows (``k1_walk_timing``);
3. weekly: the ``bench.py`` workload through the port -- a 200-particle
   depth-5 SMC fit on a 150-week series (14 structure moves x 5 HMC x 5
   leapfrog per step) and a 100-scenario x 20-draw nowcast forecast --
   scored by log-CRPS and 90% coverage, the fitted heap classes logged,
   K1's backward walk held to two class-switched launches a call;
4. daily: ``tools/daily_bench.py``'s ``daily_200p`` at seed 2 -- a
   200-particle depth-5 fit on 560 days (capacities 96 ... 576: K1/K2 up to
   512, the composed K4 -> K3 -> K5 path at 576; 8 moves x 5 HMC x 5
   leapfrog per step) and a 28-day, 2000-draw ``forecast`` -- scored the
   same way;
5. "pallas": phase 3's weekly fit under ``set_lml_backend("pallas")`` and
   ``set_cov_backend("pallas")`` (every covariance from K7F/K7B, the LML
   core from K6a/K6b), then ``forecast(..., forecast_n_hmc=1)`` of the 8
   weeks after the training window with 100 draws, scored the same way;
   K1-K5 must not launch, and K6a/K6b/K7F/K7B launch exactly the counts
   the schedule gives;
6. nowcast refresh and device engine: phase 3's weekly fit again under
   ``engine="device"``, then on phase 3's fitted model
   ``forecast_with_nowcasts`` through each refresh branch -- the
   examples' ``n_hmc=1, ess_threshold=0.5`` at S = 100, ``n_mcmc=1,
   n_hmc=1`` and ``forecast_n_hmc=1`` at S = 20, and the serial branch
   (three scenarios, one lacking the last nowcast date) -- each with its
   K1/K2 counts asserted and scored the same way, and K1/K2 ms on the
   refresh's S x P rows; last the batched branch on phase 4's daily model
   at capacity 576 and S = 20, where the scenario chunk binds (16 of 20
   scenarios a chunk), with its peak device memory held under the chunk
   budget;
7. panel and workflow: ``tools/panel_bench.py``'s workload through the
   port (``bench_torch.panel_workload``) -- ``fit_panel(engine="device")``
   of 20 series x 150 weeks x 24 particles (480 rows; 14 x 5 x 5 moves at
   proportion 0.1), K1/K2 asserted at the counts the schedule implies,
   then ``forecast_panel`` of 8 weeks x 500 draws (K4 once), each
   series' log-CRPS under that tool's gate of 0.2; ``run_acceptance`` at
   ``examples/acceptance.py``'s default budget (harsh 120-week vintage,
   4 report dates, the panel fit; five finite CRPS and WIS scores, the
   ordering printed, not gated); on phase 3's model ``decompose`` (the
   components sum to the noise-free predictive mean within
   ``DECOMPOSE_TOL``), a ``save_model`` -> ``load_model`` round trip
   (the same particle tensors) and ``device_trace`` around one
   ``predict_mvn`` (the trace names K4's ``cov_fwd_kernel``);
8. every card and beyond 2,048 points (``cards_and_large_n``): every
   kernel on every visible card bitwise cuda:0's (with several cards);
   K4/K5 at n = 2,208 and 4,096 against the float64 plain versions (8 and
   4 particles), timed at P = 200; the composed core's value and gradient
   at P = 200, n = 2,208 and 4,096 (where the particle budget binds) with
   its peak memory held under the budget; a 2,190-day daily fit of 32
   particles (capacity 2,208) and its forecast.  Phases 3, 4, 6, 7 and 8
   print ``utils/flops``' call counts, operations and MFU for their fits;
   on the device engine's fits (phase 6, phase 7) the formula's call
   counts must equal the K1/K2 launches.

Phase 2 also holds K6a (L, alpha), K6b (L^-1) and the core built on them
(value and gradients) at P = 200 and n in {32, 64, 96, 128, 160, 576}
with full and partial masks, a non-SPD lane NaN in its own lane only, and
K7F/K7B at P = 200 on the symmetric path (x2 is x1: (32, 32), (96, 96),
(160, 160), (512, 512), (8, 8), per-particle x) and the general one
((160, 8), per-particle x1 against a shared x2, and (160, 160) with x2 a
copy of x1, whose K7F must be bitwise the symmetric path's), on the hand
batch, and on depth-6 heaps holding every heap class; all four kernels
bitwise equal over two launches; then times each at P = 200, n = 160
(K7F also at (160, 8), (8, 8) and (512, 512), K7B at (512, 512) and on
the "pallas" weekly fit's own heap classes) beside
its plain version and, for K6a/K6b, the library call.  Phases 4 and 5 log
the fitted ensembles' heap classes.

Launch counts of every kernel are set to 0 just before phases 3, 4 and 5
(and before phase 5's forecast and each part of phases 6, 7 and 8) and
read just after each.  Prints
per-phase seconds, a JSON line of results, the ``kernels`` line, the
``nvidia-smi`` name/power line, and last ``{"ok": true, "device": {...}}``.
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
# covariance value, and its VJP by n (tests/test_pallas_megacov.py)
COV_RTOL, COV_ATOL = 1e-5, 1e-5
COT_TOL_SMALL, COT_TOL_LARGE = 2e-4, 2e-3
# L^-1 scaled by its largest entry per particle
INV_RTOL, INV_ATOL = 1e-3, 1e-4
# how much farther from float64 than float32 plain the kernel may be on a
# particle where float32 plain itself misses the tolerance
ILL_FACTOR = 10.0
# one-seed collapse bound on the end-to-end log-CRPS (bench.py gates the
# three-seed mean at 0.105, tools/daily_bench.py at 0.12)
MAX_LOG_CRPS = 0.2

DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


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
    from nowcastautogp_tpu_torch.ops import cudalib

    _, report = cudalib.build_library(verbose=True)
    log("ptxas:")
    for line in report.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            log("  " + line.strip())
    return smi.splitlines()[0]


def _counters():
    from nowcastautogp_tpu_torch.ops import chol, chol_mxu, cov, megacov, megalml

    return {"K1": megalml.K1_LAUNCHES, "K2": megalml.K2_LAUNCHES,
            "K3": chol_mxu.K3_LAUNCHES, "K4": megacov.K4_LAUNCHES,
            "K5": megacov.K5_LAUNCHES, "K6a": chol.K6A_LAUNCHES,
            "K6b": chol.K6B_LAUNCHES, "K7F": cov.K7F_LAUNCHES,
            "K7B": cov.K7B_LAUNCHES}


def _reset_counters():
    from nowcastautogp_tpu_torch.ops import chol, chol_mxu, cov, megacov, megalml

    for mod in (megalml, megacov, chol_mxu, chol, cov):
        mod.reset_launch_counts()


# ------------------------------------------------------------------ phase 2


def _population(P, n, seed, n_active=None, depth=5):
    """Prior-sampled particles with shared x = linspace(0, 1, n)."""
    from nowcastautogp_tpu_torch.models.config import GPConfig
    from nowcastautogp_tpu_torch.models.structures import sample_particle

    cfg = GPConfig(max_depth=depth)
    rng = np.random.default_rng(seed)
    ts, ps = zip(*[sample_particle(rng, cfg)[:2] for _ in range(P)])
    return _batch(np.stack(ts), np.stack(ps), rng, n, n_active)


# The heap classes of two fitted ensembles at seed 2 (this script's logs):
# the "pallas" path's weekly fit and the daily fit at capacity 576, whose
# composed step is K4/K5's main traffic.
FITTED_WEEKLY_CLASSES = {3: 154, 7: 28, 15: 5, 31: 13}
FITTED_DAILY_CLASSES = {15: 8, 31: 192}


def _population_of(classes, n, seed):
    """Prior trees drawn in order, each kept while its heap class still
    lacks particles, until the heap classes are ``classes`` ({class:
    particles}); x, y and noise as ``_population``'s."""
    import torch

    from nowcastautogp_tpu_torch.models.config import GPConfig
    from nowcastautogp_tpu_torch.models.structures import sample_particle
    from nowcastautogp_tpu_torch.ops.cov import heap_class

    cfg = GPConfig(max_depth=5)
    rng = np.random.default_rng(seed)
    want = dict(classes)
    ts, ps = [], []
    while any(want.values()):
        t, p = sample_particle(rng, cfg)[:2]
        c = int(heap_class(torch.as_tensor(t)[None])[0])
        if want.get(c, 0) > 0:
            want[c] -= 1
            ts.append(t)
            ps.append(p)
    return _batch(np.stack(ts), np.stack(ps), rng, n, None)


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


def _chunk_for(n):
    """Particles per call of a plain version at capacity n: its interpreter
    holds (chunk, 16, n, n) level planes (and autograd keeps them), so this
    keeps each near 1 GiB in float64."""
    return max(1, 2 ** 23 // (n * n))


def _plain_value_and_grads(args, dtype):
    """Plain version's core and (dparams, gdiag, alpha) in ``dtype``, a
    chunk of particles at a time."""
    import torch

    from nowcastautogp_tpu_torch.ops.megalml import lml_core_plain

    P, n = args[4].shape
    chunk = _chunk_for(n)
    parts = []
    for i in range(0, P, chunk):
        types, params, diagv, mask, x, ym = (
            a[i:i + chunk].to(dtype) if a.is_floating_point()
            else a[i:i + chunk] for a in args)
        p, d, y = (t.clone().requires_grad_(True)
                   for t in (params, diagv, ym))
        core = lml_core_plain(types, p, d, mask, x, y)
        ok = torch.isfinite(core)
        gp, gd, gy = torch.autograd.grad(torch.where(ok, core, 0.0).sum(),
                                         (p, d, y))
        parts.append((core.detach(), gp, gd, -gy, ok))
    out = [torch.cat(t) for t in zip(*parts)]
    return tuple(out[:4]), out[4]


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


def k1k2_parity():
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
    # every other capacity the weekly (64, 128) and daily (224 ... 512)
    # fits run K1/K2 at, at their P = 200, partly masked as a fit's buffer is
    for n in (64, 128, 224, 288, 352, 448, 512):
        cases.append((f"prior P=200 n={n} active={n - 14}",
                      _population(200, n, seed=n, n_active=n - 14)))
    cases.append(("prior P=200 n=512 active=512",
                  _population(200, 512, seed=5)))
    cases.append(("hand n=512 active=480",
                  _hand_batch(512, seed=6, n_active=480)))

    err = {"K1": 0.0, "K2": 0.0}
    for name, args in cases:
        core2 = megalml.megalml_val(*args)
        core1, dp, gd, al = megalml.megalml_vag(*args)
        ref32, ok = _plain_value_and_grads(args, torch.float32)
        ref64, ok64 = _plain_value_and_grads(args, torch.float64)
        _sync()
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


def _chunked(fn, chunk, *args):
    """``fn`` over slices of ``chunk`` particles, concatenated: the plain
    versions hold (P, n, n) planes per heap level (and autograd keeps them),
    so large n runs a few particles at a time."""
    import torch

    P = args[0].shape[0]
    return torch.cat([fn(*(a[i:i + chunk] for a in args))
                      for i in range(0, P, chunk)])


def _bitwise(a, b):
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _inv_core(X, ym):
    """The inverse core's value and gradients (dA, dym) from X = L^-1, in
    float64: isolates the error of X itself."""
    X, ym = X.double(), ym.double()
    Ainv = X.transpose(1, 2) @ X
    alpha = (Ainv @ ym[..., None])[..., 0]
    logdet = -2.0 * X.diagonal(dim1=1, dim2=2).log().sum(-1)
    core = -0.5 * ((ym * alpha).sum(-1) + logdet)
    dA = 0.5 * (alpha[:, :, None] * alpha[:, None, :] - Ainv)
    return core[:, None], dA, -alpha


def cov_inverse_parity():
    """Hold K4, K5 and K3 against their plain versions, and K4 against
    K7F's symmetric path (bitwise); returns max abs errors (K3's relative
    to each particle's largest |L^-1| entry)."""
    import torch

    from nowcastautogp_tpu_torch.ops import chol_mxu, cov, megacov

    # P = 200 at the main paths' shapes: n = 160 is the weekly nowcast's
    # K(x, x) (x shared by all particles), n = 576 the daily fit's composed
    # step and its forecast's K(x, x)
    cases = []
    for n, P in ((96, 200), (160, 200), (576, 200), (1024, 4)):
        for n_active in (n, n - 16):          # 560 of 576, as the daily fit
            cases.append((f"prior P={P} n={n} active={n_active}",
                          _population(P, n, seed=n + n_active,
                                      n_active=n_active)))
            cases.append((f"hand n={n} active={n_active}",
                          _hand_batch(n, seed=n + 1, n_active=n_active)))
    cases.append(("prior P=2 n=2048", _population(2, 2048, seed=8)))
    cases.append(("hand[8:10] n=2048 active=2000", tuple(
        a[8:10].contiguous() for a in _hand_batch(2048, 9, n_active=2000))))

    gen = torch.Generator(DEVICE).manual_seed(0)
    err = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    for name, (types, params, diagv, mask, x, ym) in cases:
        P, n = x.shape
        c = _chunk_for(n)
        K = megacov.megacov_fwd(types, params, x)
        K32 = _chunked(megacov.megacov_fwd_plain, c, types, params, x)
        K64 = _chunked(megacov.megacov_fwd_plain, c, types, params.double(),
                       x.double())
        ok = torch.isfinite(K64).flatten(1).all(1)
        check(bool(ok.all()), f"{name}: float64 covariance not finite")
        e4, _ = _parity(f"{name} K4", (K,), (K32,), (K64,), ok, COV_RTOL,
                        COV_ATOL)
        dK = torch.randn(K.shape, generator=gen, device=DEVICE)
        g = megacov.megacov_bwd(types, params, x, dK)
        g32 = _chunked(megacov.megacov_bwd_plain, c, types, params, x, dK)
        g64 = _chunked(megacov.megacov_bwd_plain, c, types, params.double(),
                       x.double(), dK.double())
        tol = COT_TOL_SMALL if n < 512 else COT_TOL_LARGE
        e5, ill5 = _parity(f"{name} K5 (asymmetric dK)", (g,), (g32,),
                           (g64,), ok, tol, tol)
        check(_bitwise(K, megacov.megacov_fwd(types, params, x)),
              f"{name}: K4 differs between two launches")
        check(_bitwise(g, megacov.megacov_bwd(types, params, x, dK)),
              f"{name}: K5 differs between two launches")
        err["K4"] = max(err["K4"], e4)
        err["K5"] = max(err["K5"], e5)
        msg = (f"parity ok: {name}: K4 {e4:.3g}, K5 {e5:.3g} (ill lanes "
               f"{ill5})")
        if chol_mxu.mxu_supported(n):
            A64 = (K64 * (mask[:, :, None] * mask[:, None, :]).double()
                   + torch.diag_embed(diagv.double()))
            A = A64.float().contiguous()
            X = chol_mxu.tri_inv(A)
            X32 = chol_mxu.tri_inv_plain(A)
            X64 = chol_mxu.tri_inv_plain(A64)
            _sync()
            fin = torch.isfinite(X).flatten(1).all(1)
            check(torch.equal(fin, torch.isfinite(X32).flatten(1).all(1)),
                  f"{name}: K3 and plain disagree on which lanes are finite")
            check(_bitwise(X, chol_mxu.tri_inv(A)),
                  f"{name}: K3 differs between two launches")
            check(torch.equal(X, torch.tril(X)), f"{name}: K3 not lower")
            okx = fin & torch.isfinite(X64).flatten(1).all(1)
            sc = X64.abs().amax((1, 2), keepdim=True)
            e3, ill3 = _parity(f"{name} K3 L^-1", (X / sc,), (X32 / sc,),
                               (X64 / sc,), okx, INV_RTOL, INV_ATOL)
            cores = [_inv_core(t, ym) for t in (X, X32, X64)]
            ev, _ = _parity(f"{name} K3 core value", cores[0][:1],
                            cores[1][:1], cores[2][:1], okx, VAL_RTOL,
                            VAL_ATOL)
            eg, _ = _parity(f"{name} K3 core gradients", cores[0][1:],
                            cores[1][1:], cores[2][1:], okx, GRAD_RTOL,
                            GRAD_ATOL)
            err["K3"] = max(err["K3"], e3)
            msg += (f", K3 {e3:.3g} scaled (core value {ev:.3g}, gradients "
                    f"{eg:.3g}; ill lanes {ill3})")
        log(msg)

    # a non-SPD particle: a negative pivot makes its lane NaN, only its lane
    types, params, diagv, mask, x, ym = _population(16, 96, seed=13)
    K = megacov.megacov_fwd(types, params, x)
    A = (K * (mask[:, :, None] * mask[:, None, :])
         + torch.diag_embed(diagv)).contiguous()
    base = chol_mxu.tri_inv(A)
    bad = A.clone()
    bad[2, 50, 50] = -1.0
    Xb = chol_mxu.tri_inv(bad)
    keep = torch.arange(16, device=DEVICE) != 2
    check(bool(torch.isnan(Xb[2]).any()), "K3: broken lane has no NaN")
    check(bool(torch.isfinite(base).all()), "K3: base batch not finite")
    check(_bitwise(Xb[keep], base[keep]),
          "K3: the broken lane changed its neighbours")
    log("parity ok: non-SPD particle isolated in K3; K3/K4/K5 bitwise "
        "equal over two launches")

    # K4 and K7F's symmetric path run the same tile code: the same bits
    for n in (160, 512):
        types, params = _population(200, n, seed=n + 3)[:2]
        x = torch.linspace(0, 1, n, device=DEVICE)
        check(_bitwise(megacov.megacov_fwd(types, params,
                                           x.expand(200, n).contiguous()),
                       cov.cov_fwd(types, params, x, x)),
              f"K4 differs from K7F's symmetric path at n = {n}")
    log("parity ok: K4 bitwise equal to K7F's symmetric path at n = 160 "
        "and 512")
    return err


def _scaled(t):
    """Divide each particle's entries by the largest |entry| of ``t``."""
    return t.abs().flatten(1).amax(1).reshape(-1, *[1] * (t.dim() - 1))


def chol_parity():
    """Hold K6a (L, alpha), K6b (L^-1) and the "pallas" LML core built on
    them (value and gradients dK, dym) against their plain versions at
    P = 200 and the weekly fit's capacities 32 ... 160, and at 576, with
    full and partial masks.  A is K4's covariance, masked, in float32: the
    float64 reference factors the same A, which isolates K6's error.
    Returns max abs errors (L and L^-1 relative to each particle's largest
    entry)."""
    import torch

    from nowcastautogp_tpu_torch.ops import chol, megacov

    def core_and_grads(A, ym, fn):
        A = A.clone().requires_grad_(True)
        y = ym.clone().requires_grad_(True)
        val = fn(A, y)
        ok = torch.isfinite(val)
        gA, gy = torch.autograd.grad(torch.where(ok, val, 0.0).sum(), (A, y))
        return (val.detach()[:, None], gA, gy), ok

    def plain_core(A, y):
        L, alpha = chol.chol_solve_plain(A, y)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * ((y * alpha).sum(-1) + logdet)

    err = {"K6a": 0.0, "K6b": 0.0}
    for n in (32, 64, 96, 128, 160, 576):
        for n_active in (n, n - 19):
            name = f"prior P=200 n={n} active={n_active}"
            types, params, diagv, mask, x, ym = _population(
                200, n, seed=2 * n + n_active, n_active=n_active)
            K = megacov.megacov_fwd(types, params, x)
            A = (K * (mask[:, :, None] * mask[:, None, :])
                 + torch.diag_embed(diagv)).contiguous()
            L, alpha = chol.chol_solve_batched(A, ym)
            X = chol.tri_inverse(L)
            _sync()
            check(_bitwise(L, chol.chol_solve_batched(A, ym)[0])
                  and _bitwise(alpha, chol.chol_solve_batched(A, ym)[1]),
                  f"{name}: K6a differs between two launches")
            check(_bitwise(X, chol.tri_inverse(L)),
                  f"{name}: K6b differs between two launches")
            check(torch.equal(L, torch.tril(L)) and torch.equal(X, torch.tril(X)),
                  f"{name}: K6a/K6b output not lower triangular")
            L32, a32 = chol.chol_solve_plain(A, ym)
            L64, a64 = chol.chol_solve_plain(A.double(), ym.double())
            fin = torch.isfinite(alpha).all(1)
            check(torch.equal(fin, torch.isfinite(a32).all(1)),
                  f"{name}: K6a and plain disagree on which lanes are finite")
            ok = fin & torch.isfinite(a64).all(1)
            check(bool(ok.any()), f"{name}: no finite lane")
            sL, sa = _scaled(L64), _scaled(a64)
            ea, ill_a = _parity(f"{name} K6a (L, alpha)", (L / sL, alpha / sa),
                                (L32 / sL, a32 / sa), (L64 / sL, a64 / sa), ok,
                                INV_RTOL, INV_ATOL)
            X32 = chol.tri_inverse_plain(L)
            X64 = chol.tri_inverse_plain(L.double())
            sX = _scaled(X64)
            eb, ill_b = _parity(f"{name} K6b L^-1", (X / sX,), (X32 / sX,),
                                (X64 / sX,), ok, INV_RTOL, INV_ATOL)
            got, okg = core_and_grads(A, ym, chol.lml_core)
            r32, _ = core_and_grads(A, ym, plain_core)
            r64, ok64 = core_and_grads(A.double(), ym.double(), plain_core)
            okc = ok & okg & ok64
            ev, _ = _parity(f"{name} K6 core value", got[:1], r32[:1],
                            r64[:1], okc, VAL_RTOL, VAL_ATOL)
            eg, ill_g = _parity(f"{name} K6 core gradients", got[1:], r32[1:],
                                r64[1:], okc, GRAD_RTOL, GRAD_ATOL)
            err["K6a"] = max(err["K6a"], ea)
            err["K6b"] = max(err["K6b"], eb)
            log(f"parity ok: {name}: K6a {ea:.3g}, K6b {eb:.3g} scaled; core "
                f"value {ev:.3g}, gradients {eg:.3g} (ill lanes {ill_a}/"
                f"{ill_b}/{ill_g})")

    # a non-SPD particle: a negative pivot makes its lane NaN, only its lane
    types, params, diagv, mask, x, ym = _population(16, 96, seed=13)
    K = megacov.megacov_fwd(types, params, x)
    A = (K * (mask[:, :, None] * mask[:, None, :])
         + torch.diag_embed(diagv)).contiguous()
    L, alpha = chol.chol_solve_batched(A, ym)
    bad = A.clone()
    bad[2, 50, 50] = -1.0
    Lb, ab = chol.chol_solve_batched(bad, ym)
    Xb, X = chol.tri_inverse(Lb), chol.tri_inverse(L)
    keep = torch.arange(16, device=DEVICE) != 2
    check(bool(torch.isnan(ab[2]).any() and torch.isnan(Xb[2]).any()),
          "K6a/K6b: broken lane has no NaN")
    check(bool(torch.isfinite(alpha).all() and torch.isfinite(X).all()),
          "K6a/K6b: base batch not finite")
    check(_bitwise(Lb[keep], L[keep]) and _bitwise(ab[keep], alpha[keep])
          and _bitwise(Xb[keep], X[keep]),
          "K6a/K6b: the broken lane changed its neighbours")
    log("parity ok: non-SPD particle isolated in K6a and K6b; both bitwise "
        "equal over two launches")
    return err


def _class_histogram(types):
    """{heap class: particles} of ``types`` by the kernels' rule."""
    from nowcastautogp_tpu_torch.ops.cov import heap_class

    c = heap_class(types).cpu()
    return {int(k): int((c == k).sum()) for k in c.unique()}


def cov_fused_parity():
    """Hold K7F and K7B (random asymmetric cotangent) against the float64
    plain interpreter at P = 200 at the "pallas" path's shapes, on both
    paths: the symmetric one (x2 is x1: the fit's K(x, x) at capacities 32,
    96 and 160, the forecast's K(xs, xs) (8, 8), the largest shape
    (512, 512), per-particle x) and the general one (K(x, xs) (160, 8),
    per-particle x against shared xs, and (160, 160) with x2 a copy of x1
    in another buffer, whose K7F must be bitwise the symmetric path's);
    the hand batch (all 8 node types) on both; depth-6 heaps in which every
    heap class 1 ... 63 appears.  Both kernels bitwise equal over two
    launches.  Returns max abs errors."""
    import torch

    from nowcastautogp_tpu_torch.ops import cov

    x = torch.linspace(0, 1, 160, device=DEVICE)
    xs = 1.0 + torch.arange(1, 9, device=DEVICE) / 159.0   # 8 weeks ahead
    heaps = [_population(200, 8, seed=i)[:2] for i in range(8)]
    jit = x + 1e-3 * torch.randn(
        (heaps[6][0].shape[0], 160), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(1))
    hand = _hand_batch(8, seed=3)[:2]
    deep = _population(200, 8, seed=0, depth=6)[:2]
    check(set(_class_histogram(deep[0])) == {1, 3, 7, 15, 31, 63},
          f"depth-6 population lacks a heap class: "
          f"{_class_histogram(deep[0])}")
    pts = {n: torch.linspace(0, 1, n, device=DEVICE) for n in (32, 96, 512)}
    cases = [  # (name, heaps, x1, x2); x2 is x1 takes the symmetric path
        ("prior (160, 160) K(x, x)", heaps[0], x, x),
        ("prior (160, 160) x2 a copy of x1", heaps[0], x, x.clone()),
        ("prior (32, 32) K(x, x)", heaps[1], pts[32], pts[32]),
        ("prior (96, 96) K(x, x)", heaps[2], pts[96], pts[96]),
        ("prior (512, 512) K(x, x)", heaps[3], pts[512], pts[512]),
        ("prior (160, 8) K(x, xs)", heaps[4], x, xs),
        ("prior (8, 8) K(xs, xs)", heaps[5], xs, xs),
        ("prior (160, 160) per-particle x, symmetric", heaps[6], jit, jit),
        ("prior (160, 8) per-particle x vs shared xs", heaps[7], jit, xs),
        ("hand (160, 160) K(x, x)", hand, x, x),
        ("hand (160, 160) x2 a copy of x1", hand, x, x.clone()),
        ("hand (160, 8) K(x, xs)", hand, x, xs),
        ("depth-6 every class (96, 96) K(x, x)", deep, pts[96], pts[96]),
    ]

    gen = torch.Generator(DEVICE).manual_seed(2)
    err = {"K7F": 0.0, "K7B": 0.0}
    K_sym = {}
    for name, (types, params), x1, x2 in cases:
        P, n, m = types.shape[0], x1.shape[-1], x2.shape[-1]
        sym = cov._symmetric(x1, x2)

        def plain(fn, dtype, *extra):
            """``fn`` in ``dtype``, a chunk of particles at a time."""
            return _chunked(fn, _chunk_for(max(n, m)), types, params.to(dtype),
                            x1.expand(P, n).to(dtype), x2.expand(P, m).to(dtype),
                            *(e.to(dtype) for e in extra))

        K = cov.cov_fwd(types, params, x1, x2)
        K32, K64 = (plain(cov.cov_fwd_plain, d) for d in (torch.float32,
                                                          torch.float64))
        ok = torch.isfinite(K64).flatten(1).all(1)
        check(bool(ok.all()), f"{name}: float64 covariance not finite")
        ef, _ = _parity(f"{name} K7F", (K,), (K32,), (K64,), ok, COV_RTOL,
                        COV_ATOL)
        dK = torch.randn((P, n, m), generator=gen, device=DEVICE)
        g = cov.cov_bwd(types, params, x1, x2, dK)
        g32, g64 = (plain(cov.cov_bwd_plain, d, dK) for d in (torch.float32,
                                                              torch.float64))
        tol = COT_TOL_SMALL if max(n, m) < 512 else COT_TOL_LARGE
        eb, ill = _parity(f"{name} K7B (asymmetric dK)", (g,), (g32,), (g64,),
                          ok, tol, tol)
        check(_bitwise(K, cov.cov_fwd(types, params, x1, x2)),
              f"{name}: K7F differs between two launches")
        check(_bitwise(g, cov.cov_bwd(types, params, x1, x2, dK)),
              f"{name}: K7B differs between two launches")
        key = (id(types), n, m)
        if sym:
            K_sym[key] = K
        elif key in K_sym:
            check(_bitwise(K, K_sym[key]),
                  f"{name}: K7F differs from the symmetric path's")
        err["K7F"] = max(err["K7F"], ef)
        err["K7B"] = max(err["K7B"], eb)
        log(f"parity ok: {name} ({'symmetric' if sym else 'general'} path, "
            f"classes {_class_histogram(types)}): K7F {ef:.3g}, K7B {eb:.3g} "
            f"(ill lanes {ill})")
    log("parity ok: K7F/K7B bitwise equal over two launches; K7F bitwise "
        "equal on the symmetric and general paths")
    return err


def _events():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _time_ms(fn, warmup=3, runs=20):
    """(ms per call, spread) by the device's clock: ``runs`` calls captured
    in one CUDA graph and replayed between two events, over ``runs``; the
    median and the max - min of three replays, after ``warmup`` eager calls
    and one replay.  This reads the kernels alone: the wrapper's host work
    (checks, ``torch.empty``, the ctypes call) is not replayed."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        a, b = _events()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / runs)
    return float(np.median(times)), float(np.ptp(times))


def _host_ms(fn, warmup=3, runs=20):
    """(ms per call, spread) with one event pair around each Python call:
    the median and interquartile range of ``runs`` calls.  What a
    host-bound caller pays for one call, wrapper included; below about
    0.1 ms it reads the host, not the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = _events()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    q1, q2, q3 = np.percentile(times, [25, 50, 75])
    return float(q2), float(q3 - q1)


def _burst_ms(fn, warmup=3, runs=20):
    """ms per call over ``runs`` eager calls back to back between two
    events: the plain versions and library calls (many launches each, not
    captured in a graph here), whose calls take far longer than their
    launches' host work."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = _events()
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def _kernel_ms(ms, name, fn, warmup=3, runs=20):
    """Time a kernel wrapper both ways: ms[name] by the device's clock,
    ms[name + "_host"] one call at a time, and ms[name + "_spread"] the
    two spreads [device, host]."""
    (dev, dev_spread), (host, host_spread) = (
        _time_ms(fn, warmup, runs), _host_ms(fn, warmup, runs))
    ms[name], ms[name + "_host"] = dev, host
    ms[name + "_spread"] = [dev_spread, host_spread]


def _k1_split_ms(fn, warmup=1, runs=5):
    """Device ms per call of each of K1's kernels -- the factorisation
    (``megalml_vag_kernel``), the backward walk's launches (every
    ``megalml_bwd_kernel`` instantiation) and the tile sum
    (``reduce_tiles_kernel``) -- from ``torch.profiler``'s records of the
    card over ``runs`` eager calls of ``fn``, and the walk's launches a
    call (``bwd_launches``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kinds = {"vag": "megalml_vag_kernel", "bwd": "megalml_bwd_kernel",
             "reduce": "reduce_tiles_kernel"}
    out = dict.fromkeys(kinds, 0.0)
    launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        for key, kernel in kinds.items():
            if kernel in e.name():
                out[key] += e.duration_ns() / 1e6 / runs
                launches += key == "bwd"
    out["bwd_launches"] = launches / runs
    return out


def _refresh_rows(pop, S=100):
    """The nowcast refresh's K1 operands at the weekly capacity: a
    population of 200 rows tiled over S scenarios (20,000 rows)."""
    return tuple(a.repeat(S, *[1] * (a.dim() - 1)).contiguous() for a in pop)


def k1_walk_timing():
    """K1's kernels by the device's clock at the shapes the backward walk
    runs: P = 200 at n = 160 (the weekly fit's largest capacity) and 512
    (K1's largest, the daily fit's), on the K1 timing population (prior
    trees) and on populations with a fitted ensemble's heap classes
    (``FITTED_WEEKLY_CLASSES`` at 160, ``FITTED_DAILY_CLASSES`` at 512),
    and the refresh's 20,000 rows at n = 160 (the weekly-fitted
    population tiled over 100 scenarios).  For each: ms of the whole call
    (``_time_ms``) and its split by kernel (``_k1_split_ms``)."""
    from nowcastautogp_tpu_torch.ops import megalml

    pops = {"n160_prior": (_population(200, 160, seed=7), (3, 20)),
            "n160_fitted": (_population_of(FITTED_WEEKLY_CLASSES, 160, 5),
                            (3, 20)),
            "n512_prior": (_population(200, 512, seed=4), (1, 5)),
            "n512_fitted": (_population_of(FITTED_DAILY_CLASSES, 512, 5),
                            (1, 5))}
    pops["rows20000_n160_fitted"] = (_refresh_rows(pops["n160_fitted"][0]),
                                     (1, 3))
    out = {}
    for tag, (args, (warmup, runs)) in pops.items():
        def fn():
            return megalml.megalml_vag(*args)

        ms, spread = _time_ms(fn, warmup, runs)
        out[tag] = {"ms": ms, "spread": spread,
                    "classes": _class_histogram(args[0]),
                    **_k1_split_ms(fn, 1, runs)}
        log(f"K1 walk {tag}: {out[tag]}")
    return out


def k1_walk_timing_apart():
    """``k1_walk_timing`` in a process of its own.  In one process, a
    ``torch.profiler`` run after an earlier one and other work on the card
    lost kernel records: phase 7's ``device_trace`` saw none, and a K1
    split read 1.7 walk launches a call where 2 ran."""
    out = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.k1_walk_timing()))"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)
    check(out.returncode == 0, f"k1_walk_timing exited {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _bounds(types, n, m=None, sym=True):
    """Each kernel's (bound ms, "bytes" or "operations") at P particles of
    heaps ``types`` and capacity n (K7F/K7B: n x m points; ``sym``:
    K(x, x)), from ``utils/flops.py``'s counts and the card's peaks."""
    from nowcastautogp_tpu_torch.utils.flops import bound_ms, kernel_costs

    return {k: bound_ms(*c) for k, c in kernel_costs(
        types.cpu().numpy(), n, m, sym).items()}


def kernel_timing():
    """ms per launch at the main paths' shapes: K1/K2 at P = 200, n = 160
    (the weekly fit's largest capacity) and 512 (the daily fit's), K3/K4/K5
    at P = 200, n = 576 (the daily fit's composed step), K6a/K6b/K7F/K7B at
    P = 200, n = 160 (the "pallas" path's weekly fit; K(x, x), the
    symmetric path), K7F also at the forecast's K(x, xs) (160, 8) and
    K(xs, xs) (8, 8) and at (512, 512), K7B also at (512, 512) and on the
    fitted weekly ensemble's heap classes; K4/K5 also at n = 160 and 2048
    and on the fitted daily ensemble's heap classes at 576.  Every
    kernel by the device's clock (``_time_ms``) and one call at a time
    (``_host_ms``); the plain versions, library calls and the composed LML
    core (value + gradient, value only, at n = 160, 512 and 576), their
    yardstick, over back-to-back calls (``_burst_ms``), 5 after 1 warm-up
    where a call takes milliseconds.  The plain versions of K4/K5 run in
    chunks of 25 particles, K7B's in chunks of 50: their level planes would
    not fit at P = 200.  Returns (ms, bounds)."""
    import torch

    from nowcastautogp_tpu_torch.ops import (
        chol, chol_mxu, cov, lml, megacov, megalml,
    )

    ms = {}
    args = _population(200, 160, seed=7)
    _kernel_ms(ms, "K1", lambda: megalml.megalml_vag(*args))
    _kernel_ms(ms, "K2", lambda: megalml.megalml_val(*args))
    ms["K1_plain"] = _burst_ms(
        lambda: _plain_value_and_grads(args, torch.float32))
    ms["K2_plain"] = _burst_ms(lambda: megalml.lml_core_plain(*args))
    bounds = {k: v for k, v in _bounds(args[0], 160).items()
              if k in ("K1", "K2")}
    types, params, diagv, mask, x, ym = _population(200, 576, seed=9)
    K = megacov.megacov_fwd(types, params, x)
    A = (K * (mask[:, :, None] * mask[:, None, :])
         + torch.diag_embed(diagv)).contiguous()
    dK = torch.randn(K.shape, generator=torch.Generator(DEVICE).manual_seed(1),
                     device=DEVICE)
    eye = torch.eye(A.shape[-1], device=DEVICE).expand_as(A)

    def library_inverse():
        L = torch.linalg.cholesky_ex(A)[0]
        return torch.linalg.solve_triangular(L, eye, upper=False)

    log(f"heap classes of the K4/K5 timing population: "
        f"{_class_histogram(types)}")
    _kernel_ms(ms, "K4", lambda: megacov.megacov_fwd(types, params, x))
    _kernel_ms(ms, "K5", lambda: megacov.megacov_bwd(types, params, x, dK))
    # K4/K5 also on the daily fit's own heap classes at n = 576 (its
    # composed step's traffic), at the nowcast's K(x, x), n = 160, and at
    # the composed path's largest capacity, 2048 (the timing trees)
    t_d, p_d, _, _, x_d, _ = _population_of(FITTED_DAILY_CLASSES, 576, 5)
    log(f"heap classes of the K4/K5 daily-fitted-like population: "
        f"{_class_histogram(t_d)}")
    _kernel_ms(ms, "K4_daily", lambda: megacov.megacov_fwd(t_d, p_d, x_d))
    _kernel_ms(ms, "K5_daily",
               lambda: megacov.megacov_bwd(t_d, p_d, x_d, dK))
    b_d = _bounds(t_d, 576)
    bounds.update({"K4_daily": b_d["K4"], "K5_daily": b_d["K5"]})
    for n, reps in ((160, (3, 20)), (2048, (1, 5))):
        t_n, p_n, _, _, x_n, _ = _population(200, n, seed=9)
        dK_n = torch.randn((200, n, n), device=DEVICE,
                           generator=torch.Generator(DEVICE).manual_seed(n))
        _kernel_ms(ms, f"K4_n{n}", lambda: megacov.megacov_fwd(t_n, p_n, x_n),
                   *reps)
        _kernel_ms(ms, f"K5_n{n}",
                   lambda: megacov.megacov_bwd(t_n, p_n, x_n, dK_n), *reps)
        b_n = _bounds(t_n, n)
        bounds.update({f"K4_n{n}": b_n["K4"], f"K5_n{n}": b_n["K5"]})
        del dK_n
    _kernel_ms(ms, "K3", lambda: chol_mxu.tri_inv(A))
    ms.update({
        "K3_plain": _burst_ms(lambda: chol_mxu.tri_inv_plain(A)),
        "K3_library": _burst_ms(library_inverse),
        "K4_plain": _burst_ms(lambda: _chunked(
            megacov.megacov_fwd_plain, 25, types, params, x), 1, 5),
        "K5_plain": _burst_ms(lambda: _chunked(
            megacov.megacov_bwd_plain, 25, types, params, x, dK), 1, 5),
    })
    bounds.update({k: v for k, v in _bounds(types, 576).items()
                   if k in ("K3", "K4", "K5")})

    # the two LML paths at the daily fit's largest shapes: K1/K2 at 512,
    # the composed core (K4 -> K3, K5 in the backward) at 576; and the
    # composed core at K1/K2's own shapes, n = 160 and 512, as their
    # yardstick (the same function, decomposed)
    p = params.clone().requires_grad_(True)

    def composed_value_and_grad():
        lml.lml_core(types, p, diagv, mask, x, ym).sum().backward()

    def composed_value():
        with torch.no_grad():
            lml.lml_core(types, params, diagv, mask, x, ym)

    ms["composed_vag_n576"] = _burst_ms(composed_value_and_grad, 1, 5)
    ms["composed_val_n576"] = _burst_ms(composed_value, 1, 5)
    for n, seed in ((160, 7), (512, 4)):
        args = _population(200, n, seed=seed)
        if n == 512:
            _kernel_ms(ms, "K1_n512", lambda: megalml.megalml_vag(*args), 1, 5)
            _kernel_ms(ms, "K2_n512", lambda: megalml.megalml_val(*args), 1, 5)
            b512 = _bounds(args[0], 512)
            bounds.update({"K1_n512": b512["K1"], "K2_n512": b512["K2"]})
        pk = args[1].clone().requires_grad_(True)
        rest = args[2:]

        def yard_vag():
            lml.lml_core_composed(args[0], pk, *rest).sum().backward()

        def yard_val():
            with torch.no_grad():
                lml.lml_core_composed(*args)

        ms[f"composed_vag_n{n}"] = _burst_ms(yard_vag, 1, 5)
        ms[f"composed_val_n{n}"] = _burst_ms(yard_val, 1, 5)

    # the "pallas" path's kernels at the weekly fit's largest shape, P = 200
    # and n = 160 (K7F/K7B: K(x, x) of one buffer), and K7F/K7B at the
    # forecast's K(x, xs) (160, 8) and K(xs, xs) (8, 8) and at (512, 512)
    types, params, diagv, mask, x, ym = _population(200, 160, seed=11)
    x1 = x[0].contiguous()
    xs = 1.0 + torch.arange(1, 9, device=DEVICE) / 159.0
    x512 = torch.linspace(0, 1, 512, device=DEVICE)
    K = megacov.megacov_fwd(types, params, x)
    A = (K * (mask[:, :, None] * mask[:, None, :])
         + torch.diag_embed(diagv)).contiguous()
    L = chol.chol_solve_batched(A, ym)[0]
    eye = torch.eye(160, device=DEVICE).expand_as(A)
    gen = torch.Generator(DEVICE).manual_seed(3)
    dK = torch.randn(K.shape, generator=gen, device=DEVICE)
    dK512 = torch.randn((200, 512, 512), generator=gen, device=DEVICE)

    def library_solve():
        Lc = torch.linalg.cholesky_ex(A)[0]
        return torch.cholesky_solve(ym[..., None], Lc)

    _kernel_ms(ms, "K6a", lambda: chol.chol_solve_batched(A, ym))
    _kernel_ms(ms, "K6b", lambda: chol.tri_inverse(L))
    _kernel_ms(ms, "K7F", lambda: cov.cov_fwd(types, params, x1, x1))
    _kernel_ms(ms, "K7F_n160_m8", lambda: cov.cov_fwd(types, params, x1, xs))
    _kernel_ms(ms, "K7F_n8_m8", lambda: cov.cov_fwd(types, params, xs, xs))
    _kernel_ms(ms, "K7F_n512",
               lambda: cov.cov_fwd(types, params, x512, x512))
    _kernel_ms(ms, "K7B", lambda: cov.cov_bwd(types, params, x1, x1, dK))
    _kernel_ms(ms, "K7B_n512",
               lambda: cov.cov_bwd(types, params, x512, x512, dK512))
    # K7B also on the "pallas" weekly fit's own heap classes
    t_f, p_f = _population_of(FITTED_WEEKLY_CLASSES, 160, 5)[:2]
    _kernel_ms(ms, "K7B_fitted", lambda: cov.cov_bwd(t_f, p_f, x1, x1, dK))
    bounds["K7B_fitted"] = _bounds(t_f, 160)["K7B"]
    ms.update({
        "K6a_plain": _burst_ms(lambda: chol.chol_solve_plain(A, ym)),
        "K6a_library": _burst_ms(library_solve),
        "K6b_plain": _burst_ms(lambda: chol.tri_inverse_plain(L)),
        "K6b_library": _burst_ms(
            lambda: torch.linalg.solve_triangular(L, eye, upper=False)),
        "K7F_plain": _burst_ms(lambda: cov.cov_fwd_plain(types, params, x1,
                                                         x1)),
        "K7F_n160_m8_plain": _burst_ms(
            lambda: cov.cov_fwd_plain(types, params, x1, xs)),
        "K7B_plain": _burst_ms(lambda: _chunked(
            lambda t, p, d: cov.cov_bwd_plain(t, p, x1, x1, d), 50, types,
            params, dK), 1, 5),
    })
    b160 = _bounds(types, 160)
    bounds.update({k: b160[k] for k in ("K6a", "K6b", "K7F", "K7B")})
    bounds["K7F_n160_m8"] = _bounds(types, 160, 8)["K7F"]
    bounds["K7F_n8_m8"] = _bounds(types, 8)["K7F"]
    b512 = _bounds(types, 512)
    bounds["K7F_n512"], bounds["K7B_n512"] = b512["K7F"], b512["K7B"]
    log(f"heap classes of the K6/K7 timing population: "
        f"{_class_histogram(types)}")
    return ms, bounds


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


def _fingerprint(model):
    """sha256 of the fitted ensemble's state: the fit is a pure function of
    its seed, so an unchanged fit path gives the same digest."""
    import hashlib

    d = model.to_dict()
    h = hashlib.sha256()
    for key in ("node_types", "params", "log_noise", "lml", "log_weight",
                "hmc_eps_scale"):
        h.update(np.ascontiguousarray(d[key]).tobytes())
    return h.hexdigest()[:16]


def _score(ngp, fc, truth):
    crps = float(ngp.crps_matrix(np.log(np.maximum(fc, 1e-9)),
                                 np.log(truth)).mean())
    q = ngp.quantile_matrix_device(fc, [0.05, 0.95], device=DEVICE)
    cover90 = float(np.mean((truth >= q[0]) & (truth <= q[1])))
    check(crps <= MAX_LOG_CRPS, f"log-CRPS {crps:.4f} > {MAX_LOG_CRPS}")
    return crps, cover90


def _weekly_data(ngp, seed, n_train, n_total):
    dates, obs = _series(n_total, seed)
    fwd, inv = ngp.get_transformations("boxcox", obs[:n_train])
    data = ngp.create_transformed_data(dates[:n_train], obs[:n_train],
                                       transformation=fwd)
    return dates, obs, data, fwd, inv


def _weekly_fit(ngp, data, seed, n_particles, engine="host"):
    return ngp.make_and_fit_model(
        data, n_particles=n_particles, smc_data_proportion=0.1,
        n_mcmc=14, n_hmc=5, seed=seed, config=ngp.GPConfig(max_depth=5),
        hmc_config=ngp.HMCConfig(n_leapfrog=5), engine=engine,
        device=DEVICE)


def _weekly_nowcasts(ngp, seed, n_train, n_scenarios, horizon):
    """bench.py's weekly series, fit data and nowcast scenarios: the two
    weeks after the training window, still being revised, and the 8
    forecast weeks after them."""
    dates, obs, data, fwd, inv = _weekly_data(ngp, seed, n_train,
                                              n_train + 2 + horizon)
    rng = np.random.default_rng(seed + 1)
    nc_dates = dates[n_train:n_train + 2]
    nc_draws = obs[n_train:n_train + 2] * rng.lognormal(
        0.1, 0.027, size=(n_scenarios, 2))
    ncs = ngp.create_nowcast_data(list(nc_draws), nc_dates,
                                  transformation=fwd)
    f_dates = [nc_dates[-1] + dt.timedelta(weeks=i + 1)
               for i in range(horizon)]
    return {"data": data, "fwd": fwd, "inv": inv, "ncs": ncs,
            "nc_dates": nc_dates, "nc_draws": nc_draws, "f_dates": f_dates,
            "truth": obs[n_train + 2:n_train + 2 + horizon]}


def weekly(seed=2, n_particles=200, n_train=150, n_scenarios=100,
           draws_per=20, horizon=8):
    """Phase 3; returns its results and, for phase 6, the fitted model and
    its nowcast inputs."""
    import torch

    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch.ops import megalml

    ctx = _weekly_nowcasts(ngp, seed, n_train, n_scenarios, horizon)
    data, inv, ncs, f_dates = (ctx[k] for k in ("data", "inv", "ncs",
                                                "f_dates"))

    _reset_counters()
    _sync()
    t0 = time.time()
    model = _weekly_fit(ngp, data, seed, n_particles)
    _sync()
    fit_s = time.time() - t0
    t0 = time.time()
    fc = ngp.forecast_with_nowcasts(model, ncs, f_dates, draws_per,
                                    inv_transformation=inv, ess_threshold=0.5)
    _sync()
    nowcast_s = time.time() - t0
    launches = _counters()

    check(fc.shape == (horizon, n_scenarios * draws_per),
          f"forecast shape {fc.shape}")
    check(bool(np.all(np.isfinite(fc)) and np.all(fc >= 0)),
          "forecast has non-finite or negative draws")
    # the fit is K1/K2 alone (capacities <= 160): 10 steps x 14 moves x
    # (1 + 5 HMC x 5 leapfrog) gradient calls, 10 x (1 reweight + 14
    # proposals) value calls; the nowcast takes K(x, x) from K4
    check((launches["K1"], launches["K2"]) == (3640, 150),
          f"weekly K1/K2 launches {launches['K1']}/{launches['K2']}, "
          "expected 3640/150")
    # capacities up to 160 at P = 200: under 4,096 blocks, so every K1
    # call's backward walk is two class-switched launches
    check(megalml.K1_BWD_LAUNCHES == 2 * 3640,
          f"weekly K1 backward-walk launches {megalml.K1_BWD_LAUNCHES}, "
          "expected 2 x 3640")
    check(launches["K4"] > 0, "K4 was not launched on the weekly path")
    crps, cover90 = _score(ngp, fc, ctx["truth"])
    ctx["model"] = model
    classes = _class_histogram(torch.as_tensor(model._host_types))
    log(f"weekly: fitted heap classes {classes}")
    # the formula counts the device engine's calls (3,650 / 10); this host
    # engine's fit makes 3,640 / 150
    return {"fit_s": fit_s, "nowcast_s": nowcast_s, "log_crps": crps,
            "coverage90": cover90, "fit_sha256": _fingerprint(model),
            "launches": launches, "heap_classes": classes,
            "flops": _fit_cost(ngp, model, n_train, 0.1, 14, 5, fit_s)}, ctx


# ------------------------------------------------------------------ phase 4


def simulate_daily(n_days: int, seed: int):
    """Daily counts: seasonal wave x weekday reporting effect x noise
    (``tools/daily_bench.py``'s generator)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_days)
    season = 0.6 * np.sin(2 * np.pi * t / 365.0 + rng.uniform(0, 2 * np.pi))
    weekday = np.array([0.05, 0.12, 0.10, 0.06, 0.0, -0.25, -0.35])
    dow = weekday[t % 7] * rng.uniform(0.8, 1.2)
    trend = rng.uniform(0.0006, 0.0018) * t
    truth = 140 * np.exp(season + dow + trend)
    obs = np.maximum(truth * np.exp(0.08 * rng.standard_normal(n_days)), 1.0)
    dates = [dt.date(2024, 1, 1) + dt.timedelta(days=int(i)) for i in t]
    return dates, obs


def _daily_fit(ngp, data, seed, n_particles):
    return ngp.make_and_fit_model(
        data, n_particles=n_particles, smc_data_proportion=0.125, n_mcmc=8,
        n_hmc=5, seed=seed, config=ngp.GPConfig(max_depth=5), device=DEVICE)


def _daily_data(ngp, seed, n_train, horizon):
    dates, obs = simulate_daily(n_train + horizon, seed)
    fwd, inv = ngp.get_transformations("boxcox", obs[:n_train])
    data = ngp.create_transformed_data(dates[:n_train], obs[:n_train],
                                       transformation=fwd)
    return dates, obs, data, fwd, inv


def daily(seed=2, n_particles=200, n_train=560, horizon=28, draws=2000):
    import torch

    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch.ops import megalml

    dates, obs, data, fwd, inv = _daily_data(ngp, seed, n_train, horizon)
    _reset_counters()
    _sync()
    t0 = time.time()
    model = _daily_fit(ngp, data, seed, n_particles)
    _sync()
    fit_s = time.time() - t0
    fit_launches = _counters()
    fit_sha256 = _fingerprint(model)
    classes = _class_histogram(torch.as_tensor(model._host_types))
    log(f"daily: heap classes of the fitted ensemble: {classes}; K1's "
        f"backward walk {megalml.K1_BWD_LAUNCHES} launches over "
        f"{fit_launches['K1']} calls")
    t0 = time.time()
    fc = ngp.forecast(model, dates[n_train:], draws, inv_transformation=inv)
    _sync()
    forecast_s = time.time() - t0
    launches = _counters()

    check(model._cap == 576, f"daily capacity {model._cap}, expected 576")
    check(fc.shape == (horizon, draws), f"forecast shape {fc.shape}")
    check(bool(np.all(np.isfinite(fc)) and np.all(fc >= 0)),
          "forecast has non-finite or negative draws")
    for k in ("K1", "K2", "K3", "K4", "K5"):
        check(launches[k] > 0, f"{k} was not launched on the daily path")
    crps, cover90 = _score(ngp, fc, obs[n_train:])
    ctx = {"model": model, "dates": dates, "obs": obs, "fwd": fwd,
           "inv": inv, "n_train": n_train}
    return {"fit_s": fit_s, "forecast_s": forecast_s, "log_crps": crps,
            "coverage90": cover90, "fit_sha256": fit_sha256,
            "fit_classes": classes, "fit_launches": fit_launches,
            "launches": launches,
            "flops": _fit_cost(ngp, model, n_train, 0.125, 8, 5, fit_s)}, ctx


# ------------------------------------------------------------------ phase 5


def pallas_weekly(seed=2, n_particles=200, n_train=150, horizon=8,
                  draws=100):
    """Phase 3's weekly fit under both "pallas" backends (K7F/K7B
    covariances, the K6a/K6b core), then ``forecast`` of the 8 weeks after
    the training window with one HMC refresh before each of 100 draws."""
    import torch

    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch.ops import cov, lml

    dates, obs, data, fwd, inv = _weekly_data(ngp, seed, n_train,
                                              n_train + 2 + horizon)
    f_dates = dates[n_train:n_train + horizon]
    saved = lml._LML_BACKEND, cov._COV_BACKEND
    lml.set_lml_backend("pallas")
    cov.set_cov_backend("pallas")
    try:
        _reset_counters()
        _sync()
        t0 = time.time()
        model = _weekly_fit(ngp, data, seed, n_particles)
        _sync()
        fit_s = time.time() - t0
        fit_launches = _counters()
        fit_sha256 = _fingerprint(model)
        classes = _class_histogram(torch.as_tensor(model._host_types))
        log(f"pallas: heap classes of the fitted ensemble: {classes}")
        _reset_counters()
        t0 = time.time()
        fc = ngp.forecast(model, f_dates, draws, inv_transformation=inv,
                          forecast_n_hmc=1)
        _sync()
        forecast_s = time.time() - t0
        fc_launches = _counters()
    finally:
        lml.set_lml_backend(saved[0])
        cov.set_cov_backend(saved[1])

    check(fc.shape == (horizon, draws), f"forecast shape {fc.shape}")
    check(bool(np.all(np.isfinite(fc)) and np.all(fc >= 0)),
          "forecast has non-finite or negative draws")
    # the fit makes phase 3's 3,640 gradient and 150 value calls, each one
    # K7F (K(x, x)) and one K6a, a gradient also one K6b and one K7B; the
    # forecast makes 100 draws x (1 + 5 leapfrog) gradient calls and 100
    # predictives of 3 covariances each (K(x, x), K(x, xs), K(xs, xs))
    for phase, got, want in (
            ("fit", fit_launches, {"K7F": 3790, "K6a": 3790, "K6b": 3640,
                                   "K7B": 3640}),
            ("forecast", fc_launches, {"K7F": 900, "K6a": 600, "K6b": 600,
                                       "K7B": 600})):
        want = {**{k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}, **want}
        check(got == want, f"pallas {phase} launches {got}, expected {want}")
    crps, cover90 = _score(ngp, fc, obs[n_train:n_train + horizon])
    launches = {k: fit_launches[k] + fc_launches[k] for k in fit_launches}
    return {"fit_s": fit_s, "forecast_s": forecast_s, "log_crps": crps,
            "coverage90": cover90, "fit_sha256": fit_sha256,
            "fit_classes": classes, "fit_launches": fit_launches,
            "launches": launches}


# ------------------------------------------------------------------ phase 6


def _nowcast_part(name, ngp, ctx, fn, want=None, kernels=("K1", "K2")):
    """One part of phase 6: the launch counts set to 0, ``fn()`` -> the
    forecast (horizon, columns), checked and scored against the held-out
    truth; ``want`` the exact K1/K2 counts the part must launch; each of
    ``kernels`` must launch."""
    _reset_counters()
    _sync()
    t0 = time.time()
    fc = fn()
    _sync()
    seconds = time.time() - t0
    launches = _counters()
    counts = {k: launches[k] for k in ("K1", "K2", "K3", "K4", "K5")}
    log(f"nowcast/{name}: {seconds:.3f} s, launches {counts}")
    check(bool(np.all(np.isfinite(fc)) and np.all(fc >= 0)),
          f"{name}: forecast has non-finite or negative draws")
    if want is not None:
        check((counts["K1"], counts["K2"]) == want,
              f"{name}: K1/K2 launches {counts['K1']}/{counts['K2']}, "
              f"expected {want[0]}/{want[1]}")
    for k in kernels:
        check(counts[k] > 0, f"{name}: {k} was not launched")
    crps, cover90 = _score(ngp, fc, ctx["truth"])
    return {"seconds": seconds, "columns": fc.shape[1], "log_crps": crps,
            "coverage90": cover90, "launches": launches}


def _k1_at_rows(ngp, model, ncs):
    """ms per K1 and K2 launch (one call at a time; each call is long, so
    host work is negligible) on the nowcast refresh's rows: the fitted
    ensemble tiled over the scenarios, with their nowcast buffers."""
    import torch

    from nowcastautogp_tpu_torch import nowcast
    from nowcastautogp_tpu_torch.ops import lml, megalml

    S, P = len(ncs), model.num_particles
    x_row, y_rows, _, mask_new = nowcast._scenario_buffers(model, ncs)
    t = model._tensor
    R, cap = S * P, x_row.shape[0]
    mask = t(mask_new).expand(R, cap).contiguous()
    args = (model._types_d().repeat(S, 1), model._params_d.repeat(S, 1, 1),
            (mask * (torch.exp(model._log_noise_d.repeat(S))[:, None]
                     + lml.DEFAULT_JITTER) + (1 - mask)).contiguous(),
            mask, t(x_row).expand(R, cap).contiguous(),
            (t(np.repeat(y_rows, P, axis=0)) * mask).contiguous())
    k1 = _host_ms(lambda: megalml.megalml_vag(*args), warmup=1, runs=5)[0]
    k2 = _host_ms(lambda: megalml.megalml_val(*args), warmup=1, runs=5)[0]
    return {"rows": R, "capacity": cap, "K1_ms": k1, "K2_ms": k2}


def _chunked_refresh(ngp, dy_ctx, n_scenarios=20, draws_per=20,
                     horizon=26):
    """The batched branch where its scenario chunk binds: phase 4's daily
    model at capacity 576 (the composed K4 -> K3 -> K5 path), nowcasts of
    the two days after its training window, ``n_hmc=1``.  Returns the
    part's results with the chunk, the peak device bytes above what was
    allocated before the call, and the same per row beside the budget."""
    import torch

    from nowcastautogp_tpu_torch import nowcast
    from nowcastautogp_tpu_torch.ops import lml

    model, dates, obs, n0 = (dy_ctx[k] for k in ("model", "dates", "obs",
                                                 "n_train"))
    rng = np.random.default_rng(7)
    nc_draws = obs[n0:n0 + 2] * rng.lognormal(0.1, 0.027,
                                              size=(n_scenarios, 2))
    ncs = ngp.create_nowcast_data(list(nc_draws), dates[n0:n0 + 2],
                                  transformation=dy_ctx["fwd"])
    cap = nowcast._scenario_cap(model, ncs[0].ds)
    chunk = nowcast._scenario_chunk(model, ncs)
    check(cap == 576 and chunk < n_scenarios,
          f"chunked refresh: capacity {cap}, chunk {chunk} of "
          f"{n_scenarios}: the budget does not bind")
    truth_ctx = {"truth": obs[n0 + 2:n0 + 2 + horizon]}
    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = _nowcast_part(
        f"chunked (n_hmc=1, S={n_scenarios}, capacity {cap})", ngp,
        truth_ctx, lambda: ngp.forecast_with_nowcasts(
            model, ncs, dates[n0 + 2:n0 + 2 + horizon], draws_per,
            inv_transformation=dy_ctx["inv"], n_hmc=1),
        kernels=("K3", "K4", "K5"))
    peak = torch.cuda.max_memory_allocated() - base
    rows = chunk * model.num_particles
    budget_row = lml.budget_bytes(1, cap)
    out.update({"capacity": cap, "chunk": chunk, "peak_bytes": peak,
                "peak_bytes_per_row": peak / rows,
                "budget_bytes_per_row": budget_row,
                "budget_bytes": lml._CHUNK_BYTES})
    log(f"chunked refresh: {chunk} scenarios a chunk, peak {peak} B above "
        f"the model ({peak / rows:.0f} B a row, budget {budget_row} B)")
    check(peak <= lml._CHUNK_BYTES,
          f"chunked refresh: peak {peak} B over the budget "
          f"{lml._CHUNK_BYTES} B")
    return out


def nowcast_refresh(wk_ctx, dy_ctx, seed=2, n_particles=200, n_train=150,
                    draws_per=20, horizon=8, small_s=20):
    """Phase 6: the weekly fit again under the device-proposal engine, then
    the nowcast refresh branches on phase 3's fitted model (no new fit):
    the examples' call (``n_hmc=1, ess_threshold=0.5``, S = 100, the
    batched branch), the batched MCMC refresh (``n_mcmc=1, n_hmc=1``,
    S = 20, through ``rejuvenation_sweep``), per-draw HMC
    (``forecast_n_hmc=1``, S = 20, the nowcast scan) and the serial branch
    (three scenarios whose date axes differ, ``n_hmc=1``); then the
    batched branch in chunks on phase 4's daily model
    (``_chunked_refresh``)."""
    import torch

    import nowcastautogp_tpu_torch as ngp

    out = {}
    ctx = _weekly_nowcasts(ngp, seed, n_train, len(wk_ctx["ncs"]), horizon)
    _reset_counters()
    _sync()
    t0 = time.time()
    dmodel = _weekly_fit(ngp, ctx["data"], seed, n_particles, engine="device")
    _sync()
    fit_s = time.time() - t0
    fit_launches = _counters()
    classes = _class_histogram(torch.as_tensor(dmodel._host_types))
    log(f"device engine: heap classes of the fitted ensemble: {classes}")
    # 10 steps: one reweight (K2) each; one gradient call to seed the sweep,
    # then 14 moves x (1 proposal + 5 HMC x 5 leapfrog) gradient calls
    check((fit_launches["K1"], fit_launches["K2"]) == (3650, 10),
          f"device-engine fit K1/K2 launches {fit_launches['K1']}/"
          f"{fit_launches['K2']}, expected 3650/10")
    cost = _fit_cost(ngp, dmodel, n_train, 0.1, 14, 5, fit_s)
    check((cost["gradient_calls"], cost["value_calls"]) == (3650, 10),
          f"utils/flops counts {cost['gradient_calls']} gradient / "
          f"{cost['value_calls']} value calls, the device engine 3650/10")
    t0 = time.time()
    fc = ngp.forecast_with_nowcasts(dmodel, ctx["ncs"], ctx["f_dates"],
                                    draws_per, inv_transformation=ctx["inv"],
                                    ess_threshold=0.5)
    _sync()
    nowcast_s = time.time() - t0
    crps, cover90 = _score(ngp, fc, ctx["truth"])
    out["device_engine"] = {
        "fit_s": fit_s, "nowcast_s": nowcast_s, "log_crps": crps,
        "coverage90": cover90, "fit_sha256": _fingerprint(dmodel),
        "fit_classes": classes, "fit_launches": fit_launches,
        "flops": cost}
    del dmodel

    model, ncs, f_dates, inv = (wk_ctx[k] for k in ("model", "ncs",
                                                    "f_dates", "inv"))
    before = _fingerprint(model)
    torch.cuda.reset_peak_memory_stats()
    # S = 100 x P = 200 rows: K2 twice (old and new LML), K1 once to seed
    # HMC and once per leapfrog
    out["examples"] = _nowcast_part(
        "examples (n_hmc=1, S=100)", ngp, wk_ctx,
        lambda: ngp.forecast_with_nowcasts(
            model, ncs, f_dates, draws_per, inv_transformation=inv, n_hmc=1,
            ess_threshold=0.5), want=(6, 2))
    out["examples"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    # the sweep: one gradient call at the start, then per move one for the
    # proposal and one per leapfrog
    out["mcmc"] = _nowcast_part(
        "batched MCMC (n_mcmc=1, n_hmc=1, S=20)", ngp, wk_ctx,
        lambda: ngp.forecast_with_nowcasts(
            model, ncs[:small_s], f_dates, draws_per,
            inv_transformation=inv, n_mcmc=1, n_hmc=1), want=(7, 2))
    out["scan"] = _nowcast_part(
        "per-draw HMC (forecast_n_hmc=1, S=20)", ngp, wk_ctx,
        lambda: ngp.forecast_with_nowcasts(
            model, ncs[:small_s], f_dates, draws_per,
            inv_transformation=inv, forecast_n_hmc=1),
        want=(6 * draws_per, 2))
    # three scenarios; the third lacks the last nowcast date
    nc_dates, nc_draws = wk_ctx["nc_dates"], wk_ctx["nc_draws"]
    serial = ncs[:2] + ngp.create_nowcast_data(
        [nc_draws[2][:1]], nc_dates[:1], transformation=wk_ctx["fwd"])
    out["serial"] = _nowcast_part(
        "serial (3 date axes, n_hmc=1)", ngp, wk_ctx,
        lambda: ngp.forecast_with_nowcasts(
            model, serial, f_dates, draws_per, inv_transformation=inv,
            n_hmc=1, ess_threshold=0.5), want=(18, 3))
    check(_fingerprint(model) == before,
          "the nowcast branches changed the base model")
    for part in ("examples", "mcmc", "scan"):
        check(out[part]["launches"]["K4"] > 0,
              f"nowcast/{part}: K4 was not launched")
    out["rows"] = _k1_at_rows(ngp, model, ncs)
    out["rows_small"] = _k1_at_rows(ngp, model, ncs[:small_s])
    log(f"K1/K2 on the refresh rows: {out['rows']}, {out['rows_small']}")
    out["chunked"] = _chunked_refresh(ngp, dy_ctx)
    return out


# ------------------------------------------------------------------ phase 7

# decompose: the component means of a particle sum to its noise-free
# predictive mean (transformed scale) within this share of the series'
# standard deviation.  Both sides are float32 solves of the same A from two
# covariance routes (the interpreter; K4), so they differ by the rounding
# of A times its condition number.
DECOMPOSE_TOL = 1e-2


def _panel(ngp, draws=500):
    """The panel of ``tools/panel_bench.py`` through ``fit_panel`` and
    ``forecast_panel`` (``bench_torch.run_panel``'s workload), with the
    launch counts the schedule implies asserted."""
    import bench_torch

    dates, datasets, invs, truths = bench_torch.panel_workload()
    kw = bench_torch.panel_fit_kwargs()
    f_dates = dates[len(datasets[0].y):]
    S, P = len(datasets), kw["n_particles"]
    n_steps = len(ngp.linear_schedule(len(datasets[0].y),
                                      kw["smc_data_proportion"]))
    _reset_counters()
    _sync()
    t0 = time.time()
    models = ngp.fit_panel(datasets, seed=1, engine="device", device=DEVICE,
                           **kw)
    _sync()
    fit_s = time.time() - t0
    fit_launches = _counters()
    # per schedule step one reweight (K2) and one rejuvenation sweep: one
    # gradient call to seed it, then per move one for the proposal and one
    # per leapfrog of each HMC trajectory (K1), all over S x P rows
    n_leap = kw["hmc_config"].n_leapfrog
    want = (n_steps * (1 + kw["n_mcmc"] * (1 + kw["n_hmc"] * n_leap)),
            n_steps)
    log(f"panel: K1 = steps x (1 + n_mcmc x (1 + n_hmc x n_leapfrog)) = "
        f"{n_steps} x (1 + {kw['n_mcmc']} x (1 + {kw['n_hmc']} x {n_leap})) "
        f"= {want[0]}; K2 = steps = {want[1]}; rows {S} x {P} = {S * P}")
    check((fit_launches["K1"], fit_launches["K2"]) == want,
          f"panel fit K1/K2 launches {fit_launches['K1']}/"
          f"{fit_launches['K2']}, expected {want[0]}/{want[1]}")
    cost = _fit_cost(ngp, models, len(datasets[0].y),
                     kw["smc_data_proportion"], kw["n_mcmc"], kw["n_hmc"],
                     fit_s, n_leap)
    check((cost["gradient_calls"], cost["value_calls"]) == want,
          f"utils/flops counts {cost['gradient_calls']} / "
          f"{cost['value_calls']}, the panel's launches {want}")
    _reset_counters()
    t0 = time.time()
    fcs = ngp.forecast_panel(models, f_dates, draws,
                             inv_transformations=invs, seed=2)
    _sync()
    forecast_s = time.time() - t0
    fc_launches = _counters()
    # one predictive build over the S x P rows: K(x, x) from one K4 launch
    check(fc_launches["K4"] == 1 and fc_launches["K1"] == 0
          and fc_launches["K2"] == 0,
          f"forecast_panel launches {fc_launches}, expected K4 once")
    for fc in fcs:
        check(fc.shape == (len(f_dates), draws)
              and bool(np.all(np.isfinite(fc)) and np.all(fc >= 0)),
              "forecast_panel: a series has a bad forecast")
    crps, cover = bench_torch.score_series(fcs, truths, DEVICE)
    worst = int(np.argmax(crps))
    check(max(crps) <= bench_torch.PANEL_GATE_MAX_LOG_CRPS,
          f"panel: series {worst} log-CRPS {crps[worst]:.4f} > "
          f"{bench_torch.PANEL_GATE_MAX_LOG_CRPS}")
    log(f"panel: fit {fit_s:.3f} s, forecast {forecast_s:.3f} s, log-CRPS "
        f"median {np.median(crps):.5f}, max {max(crps):.5f}")
    launches = {k: fit_launches[k] + fc_launches[k] for k in fit_launches}
    return {"series": S, "rows": S * P, "schedule_steps": n_steps,
            "fit_s": fit_s, "forecast_s": forecast_s,
            "log_crps_per_series": crps,
            "log_crps_median": float(np.median(crps)),
            "coverage90_mean": float(np.mean(cover)),
            "fit_launches": fit_launches, "forecast_launches": fc_launches,
            "launches": launches, "flops": cost}


def _acceptance(ngp):
    """``run_acceptance`` at ``examples/acceptance.py``'s default budget
    (``bench_torch.acceptance_budget``) with the panel fit."""
    import bench_torch
    from nowcastautogp_tpu_torch.eval.acceptance import APPROACHES

    vintage, report_dates, kw = bench_torch.acceptance_budget(full=False)
    _reset_counters()
    _sync()
    t0 = time.time()
    res = ngp.run_acceptance(vintage, report_dates=report_dates,
                             device=DEVICE, **kw)
    _sync()
    seconds = time.time() - t0
    launches = _counters()
    check(set(res) == {"scores", "ratios", "per_report", "scores_wis",
                       "ratios_wis", "n_report_dates"},
          f"acceptance: result keys {sorted(res)}")
    check(res["n_report_dates"] == len(report_dates) == 4,
          f"acceptance: {res['n_report_dates']} report dates")
    for key in ("scores", "scores_wis"):
        check(tuple(res[key]) == APPROACHES
              and all(np.isfinite(v) and v > 0 for v in res[key].values()),
              f"acceptance: {key} {res[key]}")
    for k in ("K1", "K2", "K4"):
        check(launches[k] > 0, f"acceptance: {k} was not launched")
    log(f"acceptance: {seconds:.3f} s; scores {json.dumps(res['scores'])}; "
        f"ratios {json.dumps(res['ratios'])}; WIS "
        f"{json.dumps(res['scores_wis'])}; ratios "
        f"{json.dumps(res['ratios_wis'])}; headline ordering (not gated at "
        f"this budget) {bench_torch.ordering(res['scores'])}")
    return {"seconds": seconds, "scores": res["scores"],
            "ratios": res["ratios"], "scores_wis": res["scores_wis"],
            "ratios_wis": res["ratios_wis"],
            "ordering_reproduced": bench_torch.ordering(res["scores"]),
            "launches": launches}


def _model_tools(ngp, wk_ctx):
    """On phase 3's weekly model: ``decompose`` (components sum to the
    noise-free predictive mean), ``save_model`` -> ``load_model`` (the same
    particle tensors back) and ``device_trace`` around one ``predict_mvn``
    (the trace names K4's kernel, launched once)."""
    import tempfile

    import torch

    model, f_dates = wk_ctx["model"], wk_ctx["f_dates"]
    out = {}
    t0 = time.time()
    parts = ngp.decompose(model, f_dates)
    _sync()
    out["decompose_s"] = time.time() - t0
    mvn = ngp.predict_mvn(model, f_dates, include_noise=False)
    errs = []
    for p, d in enumerate(parts):
        if d.get("broken"):
            continue
        total = model._y_mean + sum(c["mean"] for c in d["components"])
        errs.append(float(np.max(np.abs(total - mvn.means[p]))))
    worst = max(errs) / model._y_std
    n_broken = sum(bool(d.get("broken")) for d in parts)
    log(f"decompose: {out['decompose_s']:.3f} s, {len(parts)} particles "
        f"({n_broken} broken), {sum(len(d['components']) for d in parts)} "
        f"components; worst |sum - mean| / y_std {worst:.3e} (tolerance "
        f"{DECOMPOSE_TOL})")
    check(n_broken < len(parts) and worst <= DECOMPOSE_TOL,
          f"decompose: components miss the predictive mean by {worst:.3e} "
          f"of y_std")
    out.update({"decompose_worst": worst, "decompose_broken": n_broken})

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT,
                                                      ".scratch")) as tmp:
        path = os.path.join(tmp, "weekly.npz")
        ngp.save_model(model, path)
        back = ngp.load_model(path)
        a, b = model.to_dict(), back.to_dict()
        for key in ("node_types", "params", "log_noise", "lml",
                    "log_weight", "hmc_eps_scale", "generator_state"):
            check(np.array_equal(a[key], b[key]),
                  f"checkpoint: {key} changed in the round trip")
        check(a["rng_state"] == b["rng_state"] and back.device == model.device,
              "checkpoint: generator or device changed in the round trip")
        out["checkpoint_bytes"] = os.path.getsize(path)

        _reset_counters()
        with ngp.device_trace(os.path.join(tmp, "trace")) as prof:
            ngp.predict_mvn(model, f_dates)
        launches = _counters()
        with open(os.path.join(tmp, "trace", "trace.json")) as f:
            trace = f.read()
        names = {e.key for e in prof.key_averages()}
    check(launches["K4"] == 1, f"traced predict_mvn launches {launches}")
    check("cov_fwd_kernel" in trace
          and any("cov_fwd_kernel" in n for n in names),
          "device_trace: K4 (cov_fwd_kernel) is not in the trace")
    log(f"checkpoint {out['checkpoint_bytes']} B round trip; device_trace "
        f"names K4's cov_fwd_kernel ({len(trace)} B trace)")
    out["launches"] = launches
    return out


def panel_and_workflow(wk_ctx):
    """Phase 7: the multi-series panel (``fit_panel``, ``forecast_panel``)
    at ``tools/panel_bench.py``'s workload, ``run_acceptance`` at
    ``examples/acceptance.py``'s default budget, and on phase 3's weekly
    model ``decompose``, a checkpoint round trip and ``device_trace``."""
    import nowcastautogp_tpu_torch as ngp

    # the checkpoint and the trace go to a git-ignored directory of the
    # checkout, removed after
    os.makedirs(os.path.join(ROOT, ".scratch"), exist_ok=True)
    out = {}
    t0 = time.time()
    out["panel"] = _panel(ngp)
    out["panel"]["seconds"] = time.time() - t0
    out["acceptance"] = _acceptance(ngp)
    out["tools"] = _model_tools(ngp, wk_ctx)
    return out


# ------------------------------------------------------------------ phase 8


def _fit_cost(ngp, models, n_train, proportion, n_mcmc, n_hmc, fit_s,
              n_leapfrog=5):
    """``utils/flops``' call counts, operations and MFU of a fit of
    ``models`` (one, or a panel's: their rows together), the fitted trees'
    walks standing for every call's."""
    from nowcastautogp_tpu_torch.utils import flops

    models = models if isinstance(models, list) else [models]
    types = np.concatenate([m._host_types for m in models])
    schedule = ngp.linear_schedule(n_train, max(proportion, 1.0 / n_train))
    kw = dict(schedule=schedule, cap_full=int(models[0]._cap),
              n_mcmc=n_mcmc, n_hmc=n_hmc, n_leapfrog=n_leapfrog)
    counts = flops.fit_call_counts(**kw)
    ops, nbytes = flops.fit_cost_analysis(
        P=types.shape[0], config=models[0].config, types=types, **kw)
    out = {"value_calls": sum(c[1] for c in counts),
           "gradient_calls": sum(c[2] for c in counts), "ops": ops,
           "bytes": nbytes, **flops.mfu(ops, fit_s)}
    log(f"flops: {json.dumps(out)}")
    return out


def _k45_beyond_2048():
    """K4 and K5 beyond the JAX kernel's 2048, held against their float64
    plain versions on a few particles (the interpreter holds about N
    planes a particle) and timed at the daily fit's P = 200 beside their
    bounds.  Returns (max abs errors, ms, bounds)."""
    import torch

    from nowcastautogp_tpu_torch.ops import megacov

    err, ms, bounds = {"K4": 0.0, "K5": 0.0}, {}, {}
    gen = torch.Generator(DEVICE).manual_seed(8)
    for n, P in ((2208, 8), (4096, 4)):
        for name, (types, params, _, _, x, _) in (
                (f"prior P={P} n={n}", _population(P, n, seed=n)),
                (f"hand[8:10] n={n}", tuple(
                    a[8:10].contiguous() for a in _hand_batch(n, n + 1)))):
            K = megacov.megacov_fwd(types, params, x)
            K32 = _chunked(megacov.megacov_fwd_plain, 1, types, params, x)
            K64 = _chunked(megacov.megacov_fwd_plain, 1, types,
                           params.double(), x.double())
            ok = torch.isfinite(K64).flatten(1).all(1)
            check(bool(ok.all()), f"{name}: float64 covariance not finite")
            e4, _ = _parity(f"{name} K4", (K,), (K32,), (K64,), ok,
                            COV_RTOL, COV_ATOL)
            del K32, K64
            dK = torch.randn(K.shape, generator=gen, device=DEVICE)
            g = megacov.megacov_bwd(types, params, x, dK)
            g32 = _chunked(megacov.megacov_bwd_plain, 1, types, params, x,
                           dK)
            g64 = _chunked(megacov.megacov_bwd_plain, 1, types,
                           params.double(), x.double(), dK.double())
            e5, ill5 = _parity(f"{name} K5 (asymmetric dK)", (g,), (g32,),
                               (g64,), ok, COT_TOL_LARGE, COT_TOL_LARGE)
            check(_bitwise(K, megacov.megacov_fwd(types, params, x))
                  and _bitwise(g, megacov.megacov_bwd(types, params, x, dK)),
                  f"{name}: K4/K5 differ between two launches")
            err["K4"], err["K5"] = max(err["K4"], e4), max(err["K5"], e5)
            log(f"parity ok: {name}: K4 {e4:.3g}, K5 {e5:.3g} (ill lanes "
                f"{ill5})")
            del K, dK, g, g32, g64
            torch.cuda.empty_cache()
        t_n, p_n, _, _, x_n, _ = _population(200, n, seed=9)
        dK_n = torch.randn((200, n, n), device=DEVICE,
                           generator=torch.Generator(DEVICE).manual_seed(n))
        _kernel_ms(ms, f"K4_n{n}", lambda: megacov.megacov_fwd(t_n, p_n, x_n),
                   1, 5)
        _kernel_ms(ms, f"K5_n{n}",
                   lambda: megacov.megacov_bwd(t_n, p_n, x_n, dK_n), 1, 5)
        b_n = _bounds(t_n, n)
        bounds.update({f"K4_n{n}": b_n["K4"], f"K5_n{n}": b_n["K5"]})
        del dK_n
        torch.cuda.empty_cache()
    return err, ms, bounds


def _core_beyond_2048(n, P=200):
    """The composed LML core's value and gradient at P particles and
    capacity n: ms per call, the particles a chunk, and the peak device
    bytes above what was allocated before, held under the budget of the
    chunk's particles.  Its K4/K5 launches are counted."""
    import torch

    from nowcastautogp_tpu_torch.ops import lml

    types, params, diagv, mask, x, ym = _population(P, n, seed=n + 7,
                                                    n_active=n - 18)
    p = params.clone().requires_grad_(True)
    chunk = lml.composed_chunk(n)

    def value_and_grad():
        core = lml.lml_core(types, p, diagv, mask, x, ym)
        core.sum().backward()
        return core

    _reset_counters()
    _sync()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    core = value_and_grad()
    _sync()
    peak = torch.cuda.max_memory_allocated() - base
    launches = _counters()
    # a chunked core's backward recomputes each chunk's forward
    n_chunks = -(-P // chunk)
    want = (n_chunks if n_chunks == 1 else 2 * n_chunks, n_chunks)
    check((launches["K4"], launches["K5"]) == want,
          f"core n={n}: K4/K5 {launches['K4']}/{launches['K5']}, expected "
          f"{want} for {n_chunks} chunks of {chunk}")
    check(bool(torch.isfinite(core).sum() > P // 2)
          and bool(torch.isfinite(p.grad).all()),
          f"core n={n}: values or gradients not finite")
    budget = lml.budget_bytes(min(P, chunk), n)
    check(peak <= budget and peak <= lml._CHUNK_BYTES,
          f"core n={n}: peak {peak} B over the budget {budget} B")
    ms = _burst_ms(value_and_grad, 0, 2)
    log(f"composed core P={P} n={n}: {ms:.1f} ms value + gradient, "
        f"{chunk} particles a chunk ({n_chunks} calls), peak {peak} B "
        f"({peak / (min(P, chunk) * n * n * 4):.2f} planes a particle; "
        f"budget {budget} B)")
    del p, core
    torch.cuda.empty_cache()
    return {"P": P, "n": n, "chunk": chunk, "calls": n_chunks, "ms": ms,
            "peak_bytes": peak, "budget_bytes": budget,
            "planes_per_particle": peak / (min(P, chunk) * n * n * 4),
            "launches": launches}


def _daily_long(ngp, seed=2, n_train=2190, horizon=28, draws=2000,
                n_particles=32):
    """A reduced fit on a 2,190-day ``simulate_daily`` series at full
    length (capacity 2,208: the composed core beyond 2048), then its
    forecast; the log-CRPS is reported against ``tools/daily_bench.py``'s
    0.12 gate, not gated here."""
    import torch

    dates, obs, data, fwd, inv = _daily_data(ngp, seed, n_train, horizon)
    _reset_counters()
    _sync()
    t0 = time.time()
    model = ngp.make_and_fit_model(
        data, n_particles=n_particles, smc_data_proportion=0.125, n_mcmc=2,
        n_hmc=2, seed=seed, config=ngp.GPConfig(max_depth=5), device=DEVICE)
    _sync()
    fit_s = time.time() - t0
    fit_launches = _counters()
    t0 = time.time()
    fc = ngp.forecast(model, dates[n_train:], draws, inv_transformation=inv)
    _sync()
    forecast_s = time.time() - t0
    launches = _counters()
    check(model._cap == 2208, f"daily long capacity {model._cap}")
    check(fc.shape == (horizon, draws)
          and bool(np.all(np.isfinite(fc)) and np.all(fc >= 0)),
          "daily long: bad forecast")
    for k in ("K1", "K2", "K3", "K4", "K5"):
        check(fit_launches[k] > 0, f"daily long: {k} was not launched")
    crps = float(ngp.crps_matrix(np.log(np.maximum(fc, 1e-9)),
                                 np.log(obs[n_train:])).mean())
    classes = _class_histogram(torch.as_tensor(model._host_types))
    log(f"daily long ({n_train} days, capacity {model._cap}): fit "
        f"{fit_s:.3f} s, forecast {forecast_s:.3f} s, log-CRPS {crps:.5f} "
        f"(tools/daily_bench.py gates 0.12; not gated here), classes "
        f"{classes}")
    return {"fit_s": fit_s, "forecast_s": forecast_s, "log_crps": crps,
            "capacity": int(model._cap), "fit_classes": classes,
            "fit_launches": fit_launches, "launches": launches,
            "flops": _fit_cost(ngp, model, n_train, 0.125, 2, 2, fit_s)}


def _every_card_kernels():
    """Every kernel launched on every visible card (under
    ``torch.cuda.device`` of that card) and held bitwise to its
    result on cuda:0: the kernels that take more than 48 KB of dynamic
    shared memory set its limit on each card (K1, K2, K3, K6a, K6b, K5's
    class-31 launch).  Returns the cards checked."""
    import torch

    from nowcastautogp_tpu_torch.ops import chol, chol_mxu, cov, megacov
    from nowcastautogp_tpu_torch.ops import megalml

    def kernels(args160, args576):
        types, params, diagv, mask, x, ym = args160
        K = megacov.megacov_fwd(types, params, x)
        A = (K * (mask[:, :, None] * mask[:, None, :])
             + torch.diag_embed(diagv)).contiguous()
        L, alpha = chol.chol_solve_batched(A, ym)
        x1 = x[0].contiguous()
        t5, p5, d5, m5, x5, _ = args576
        K5 = megacov.megacov_fwd(t5, p5, x5)
        A5 = (K5 * (m5[:, :, None] * m5[:, None, :])
              + torch.diag_embed(d5)).contiguous()
        return [megalml.megalml_val(*args160),
                *megalml.megalml_vag(*args160), L, alpha,
                chol.tri_inverse(L), cov.cov_fwd(types, params, x1, x1),
                cov.cov_bwd(types, params, x1, x1, K), K5,
                megacov.megacov_bwd(t5, p5, x5, K5), chol_mxu.tri_inv(A5)]

    a160 = _population(200, 160, seed=31)
    a576 = _population_of(FITTED_DAILY_CLASSES, 576, 5)
    ref = kernels(a160, a576)
    cards = list(range(1, torch.cuda.device_count()))
    for d in cards:
        dev = torch.device("cuda", d)
        with torch.cuda.device(dev):
            got = kernels(*(tuple(a.to(dev) for a in args)
                            for args in (a160, a576)))
            torch.cuda.synchronize()
        for i, (g, r) in enumerate(zip(got, ref)):
            check(torch.equal(g.cpu(), r.cpu()),
                  f"cuda:{d}: kernel output {i} differs from cuda:0's")
    log(f"every kernel on cards {[0] + cards} bitwise cuda:0's")
    return [0] + cards


def cards_and_large_n():
    """Phase 8: every card, and the LML beyond 2,048 points.

    * Every kernel on every visible card, bitwise cuda:0's (the shared
      memory limit is set per card).
    * K4/K5 at n = 2,208 and 4,096 against their float64 plain versions,
      timed at P = 200; the composed core's value and gradient at P = 200,
      n = 2,208 (one chunk) and n = 4,096 (the budget binds: 64 a chunk),
      with their peaks; a 2,190-day daily fit of 32 particles.
    """
    import nowcastautogp_tpu_torch as ngp

    out = {"kernels_on_cards": _every_card_kernels()}
    out["k45_err"], out["k45_ms"], out["k45_bounds"] = _k45_beyond_2048()
    out["core"] = {f"n{n}": _core_beyond_2048(n) for n in (2208, 4096)}
    out["daily_long"] = _daily_long(ngp)
    return out


def main():
    import torch

    phases = {}
    t0 = time.time()
    smi = setup()
    phases["setup"] = time.time() - t0
    t0 = time.time()
    err = k1k2_parity()
    err.update(cov_inverse_parity())
    err.update(chol_parity())
    err.update(cov_fused_parity())
    phases["parity"] = time.time() - t0
    t0 = time.time()
    ms, bounds = kernel_timing()
    walk = k1_walk_timing_apart()
    phases["timing"] = time.time() - t0
    log(f"ms per launch: {json.dumps(ms)}")
    t0 = time.time()
    wk, wk_ctx = weekly()
    phases["weekly"] = time.time() - t0
    log(f"weekly: {json.dumps(wk)}")
    t0 = time.time()
    dy, dy_ctx = daily()
    phases["daily"] = time.time() - t0
    log(f"daily: {json.dumps(dy)}")
    t0 = time.time()
    pw = pallas_weekly()
    phases["pallas"] = time.time() - t0
    log(f"pallas: {json.dumps(pw)}")
    t0 = time.time()
    nc = nowcast_refresh(wk_ctx, dy_ctx)
    phases["nowcast"] = time.time() - t0
    del dy_ctx
    log(f"nowcast: {json.dumps(nc)}")
    t0 = time.time()
    pn = panel_and_workflow(wk_ctx)
    phases["panel"] = time.time() - t0
    del wk_ctx
    log(f"panel and workflow: {json.dumps(pn)}")
    t0 = time.time()
    m8 = cards_and_large_n()
    phases["cards_large_n"] = time.time() - t0
    log(f"every card and beyond 2048: {json.dumps(m8)}")
    ms.update(m8["k45_ms"])
    bounds.update(m8["k45_bounds"])
    for k in ("K4", "K5"):
        err[k] = max(err[k], m8["k45_err"][k])
    log(f"device-engine weekly fit {nc['device_engine']['fit_s']:.3f} s, "
        f"host-engine {wk['fit_s']:.3f} s")
    log(f"phase seconds: {json.dumps(phases)}")

    csrc = "nowcastautogp_tpu_torch/csrc/"
    tpu = "nowcastautogp_tpu/ops/"
    table = [
        ("K1", "megalml_vag_kernel (LML value + gradient)", "megalml.cu",
         "pallas_megalml.py:428", "K1_plain", None),
        ("K2", "megalml_val_kernel (LML value)", "megalml.cu",
         "pallas_megalml.py:417", "K2_plain", None),
        ("K3", "tri_inv_kernel (blocked Cholesky inverse L^-1)",
         "chol_mxu.cu", "chol_mxu.py:253", "K3_plain", "K3_library"),
        ("K4", "megacov_fwd: cov_fwd_kernel, class-switched (batched "
         "K(x_p, x_p))", "covtile.cuh", "pallas_megacov.py:341", "K4_plain",
         None),
        ("K5", "megacov_bwd: cov_bwd_kernel, launches by heap class, + tile "
         "reduction (its VJP)", "covtile.cuh", "pallas_megacov.py:518",
         "K5_plain", None),
        ("K6a", "chol_solve_kernel (blocked Cholesky L and alpha)", "chol.cu",
         "pallas_chol.py:204", "K6a_plain", "K6a_library"),
        ("K6b", "tri_inverse_kernel (L^-1 from a Cholesky factor)", "chol.cu",
         "pallas_chol.py:265", "K6b_plain", "K6b_library"),
        ("K7F", "cov_fwd: cov_fwd_kernel (one tree's K(x1, x2))",
         "covtile.cuh", "pallas_cov.py:114", "K7F_plain", None),
        ("K7B", "cov_bwd: cov_bwd_kernel, launches by heap class, + tile "
         "reduction (VJP of K(x1, x2))", "covtile.cuh", "pallas_cov.py:125",
         "K7B_plain", None),
    ]
    # K1/K2 also at the daily fit's n = 512, each beside the composed core
    # (value + gradient for K1, value for K2) at its own n as the yardstick
    extra = {k: {"yardstick_ms": ms[f"composed_{kind}_n160"],
                 "yardstick_ms_n512": ms[f"composed_{kind}_n512"]}
             for k, kind in (("K1", "vag"), ("K2", "val"))}
    # each kernel's other shapes: ms (device clock), host_ms, bound_ms
    shapes = {"K1": ("n512",), "K2": ("n512",),
              "K4": ("daily", "n160", "n2048", "n2208", "n4096"),
              "K5": ("daily", "n160", "n2048", "n2208", "n4096"),
              "K7F": ("n160_m8", "n8_m8", "n512"),
              "K7B": ("n512", "fitted")}
    for k, tags in shapes.items():
        for tag in tags:
            extra.setdefault(k, {}).update({
                f"ms_{tag}": ms[f"{k}_{tag}"],
                f"host_ms_{tag}": ms[f"{k}_{tag}_host"],
                f"bound_ms_{tag}": bounds[f"{k}_{tag}"][0]})
    kernels = []
    for k, name, src, tpu_src, plain, lib in table:
        bound_ms, bound_by = bounds[k]
        by_path = {"weekly": wk["launches"][k], "daily": dy["launches"][k],
                   "pallas": pw["launches"][k],
                   "nowcast": nc["device_engine"]["fit_launches"][k]
                   + sum(nc[part]["launches"][k] for part in
                         ("examples", "mcmc", "scan", "serial",
                          "chunked")),
                   "panel": pn["panel"]["launches"][k],
                   "acceptance": pn["acceptance"]["launches"][k],
                   "workflow": pn["tools"]["launches"][k],
                   "beyond_2048": m8["daily_long"]["launches"][k]
                   + sum(c["launches"][k] for c in m8["core"].values())}
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": csrc + src,
            "replaces": tpu + tpu_src, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err[k],
            "ms": ms[k], "host_ms": ms[f"{k}_host"], "plain_ms": ms[plain],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": ms[lib] if lib else None, **extra.get(k, {})})
    print(json.dumps({"phase_s": phases, "kernel_ms": ms, "k1_walk": walk,
                      "bounds_ms": bounds, "weekly": wk, "daily": dy,
                      "pallas": pw, "nowcast": nc, "panel": pn,
                      "cards_large_n": m8}))
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
