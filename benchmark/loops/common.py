"""What the loops share: seeds, inputs of a job and the reference's view
of a fitted model."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from ..reference import data as ref_data


def seed_seq(seed: int, *tags) -> np.random.SeedSequence:
    """A seed sequence from the run's seed and integer tags.  Any whole
    seed maps to a non-negative entropy word."""
    return np.random.SeedSequence([int(v) % (1 << 64) for v in (seed, *tags)])


def seed_int(seed: int, *tags) -> int:
    """A 32-bit integer seed from the run's seed and tags."""
    return int(seed_seq(seed, *tags).generate_state(1)[0])


def series(cfg: dict, seed: int, k: int):
    """Job k's series: (dates, obs) long enough for training, the revised
    points and the horizon, from (seed, k)."""
    s = cfg["series"]
    gen = importlib.import_module(f"benchmark.series.{s['generator']}")
    n = s["n_train"] + s["n_revised"] + s["horizon"]
    return gen.generate(n, np.random.default_rng(seed_seq(seed, k, 1)))


def nowcast_values(cfg: dict, obs, seed: int, k: int, tag: int):
    """(scenarios, n_revised) nowcast draws: the revised points times
    lognormal reporting factors from (seed, k, tag)."""
    s, f = cfg["series"], cfg["forecast"]
    n0 = s["n_train"]
    rng = np.random.default_rng(seed_seq(seed, k, tag))
    mu, sigma = f["factor_lognormal"]
    return obs[n0:n0 + s["n_revised"]] * rng.lognormal(
        mu, sigma, size=(f["scenarios"], s["n_revised"]))


def fit_kwargs(ngp, cfg: dict, device) -> dict:
    f = cfg["fit"]
    return dict(n_particles=f["n_particles"],
                smc_data_proportion=f["smc_data_proportion"],
                n_mcmc=f["n_mcmc"], n_hmc=f["n_hmc"],
                config=ngp.GPConfig(max_depth=f["max_depth"]),
                hmc_config=ngp.HMCConfig(n_leapfrog=f["n_leapfrog"]),
                engine=f["engine"], device=device)


class RefView:
    """The reference's own derivation of a job's data from its raw
    series, in float64 on ``device``: the transformation, the
    normalisation of the training window, and the axes it needs."""

    def __init__(self, cfg: dict, dates, obs, device):
        s = cfg["series"]
        if s["transform"] != "boxcox":
            raise ValueError(f"the reference has no {s['transform']!r}")
        self.n0, self.n_rev = s["n_train"], s["n_revised"]
        self.h = s["horizon"]
        self.dates, self.obs = dates, np.asarray(obs, dtype=np.float64)
        train = self.obs[:self.n0]
        self.fwd = ref_data.boxcox_forward(train)
        self.norm = ref_data.Normaliser(dates[:self.n0], self.fwd(train))
        self.dev = device
        self.x_train = self._t(self.norm.x(dates[:self.n0]))
        self.y_train = self._t(self.norm.y(self.fwd(train)))
        self.x_new = self._t(self.norm.x(dates[:self.n0 + self.n_rev]))
        lo = self.n0 + self.n_rev
        self.xs = self._t(self.norm.x(dates[lo:lo + self.h]))
        self.truth = self.obs[lo:lo + self.h]

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.dev)

    def y_new(self, nc_values):
        """(n_new, S) targets of the training window followed by each
        scenario's revised points."""
        nc = self.norm.y(self.fwd(np.asarray(nc_values, dtype=np.float64)))
        y0 = np.repeat(self.norm.y(self.fwd(self.obs[:self.n0]))[:, None],
                       nc.shape[0], 1)
        return self._t(np.concatenate([y0, nc.T], 0))

    def z(self, fc):
        """Forecast draws (m, D) back on the normalised scale."""
        return self._t(self.norm.y(self.fwd(np.asarray(fc))))


def state_tensors(state: dict, device):
    """A fitted model's particles (the program's output, read to judge
    it) as float64 tensors."""
    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (t(state["node_types"], torch.int64), t(state["params"]),
            t(state["log_noise"]))


def lml_gap(prog_lml, ref_lml, scale=1.0) -> float:
    """The widest gap between the program's LMLs and the reference's over
    rows, each in units of its ``scale`` (nats by default; the row's
    float32 sensitivity, ``gp.solve(..., sens=True)``, for ``lml_err``).
    A row the reference cannot factor must carry the program's rejection
    sentinel (at or below -1e9), and then counts 0; a sentinel where the
    reference is finite counts as infinite."""
    prog = np.asarray(prog_lml, dtype=np.float64).ravel()
    ref = np.asarray(ref_lml, dtype=np.float64).ravel()
    scale = np.broadcast_to(np.asarray(scale, dtype=np.float64), ref.shape)
    sentinel = prog <= -1e9
    ref_bad = ~np.isfinite(ref)
    gap = np.abs(prog - np.where(ref_bad, 0.0, ref)) / np.where(
        ref_bad, 1.0, scale)
    gap = np.where(ref_bad, np.where(sentinel, 0.0, np.inf), gap)
    gap = np.where(sentinel & ~ref_bad, np.inf, gap)
    return float(gap.max()) if gap.size else float("inf")


def guarded(lml) -> np.ndarray:
    """LMLs as the program reports them: a row that is not finite gets
    the rejection sentinel -1e10 (the control, in the program's place)."""
    return np.where(np.isfinite(lml), lml, -1e10)


class HmcRecorder:
    """Keeps what each call of ``run_hmc`` takes and returns, where a
    program module binds it, while a unit runs: the trees, the state it
    was handed and the state and LMLs it handed on.  Installed over the
    binding (spans included) and restored by ``restore``."""

    def __init__(self, module):
        self.module = module
        self.orig = module.run_hmc
        self.kept = None
        module.run_hmc = self._call

    def _call(self, types, params, log_noise, *args, **kwargs):
        out = self.orig(types, params, log_noise, *args, **kwargs)
        if self.kept is not None:
            self.kept.append({"types": types, "params_in": params,
                              "noise_in": log_noise, "params": out[0],
                              "noise": out[1], "lml": out[2]})
        return out

    def restore(self) -> None:
        self.module.run_hmc = self.orig


def moved_rows(call: dict) -> int:
    """The rows whose parameters or noise a ``run_hmc`` call changed, bit
    for bit: an HMC step that accepts moves its row."""
    def bits(t):
        t = t.detach().contiguous()
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.view(as_int[t.element_size()]).reshape(t.shape[0], -1)

    same = ((bits(call["params"]) == bits(call["params_in"])).all(1)
            & (bits(call["noise"]) == bits(call["noise_in"])).all(1))
    return int((~same).sum())


def malformed(fc, shape) -> bool:
    fc = np.asarray(fc)
    return (fc.shape != tuple(shape) or not np.all(np.isfinite(fc))
            or bool(np.any(fc < 0)))


def pit(j: dict, z) -> np.ndarray:
    """PIT values of draws ``z`` (S, D, m) under the judged mixture."""
    from ..reference import gp

    sd = torch.sqrt(torch.clamp_min(j["var"], 1e-300))
    return gp.mixture_cdf(z, j["log_w"], j["mu"], sd).cpu().numpy().ravel()
