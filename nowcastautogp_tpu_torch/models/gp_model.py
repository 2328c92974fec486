"""GPModel: the particle ensemble over (kernel structure, hyperparameters).

Port of the JAX package's ``models/gp_model.py``.  The model is a host
object on an explicit ``device`` owning

* fixed-capacity data buffers (normalised time axis, standardised targets)
  plus a {0,1} ingestion mask, so SMC data annealing and ``add_data`` never
  change shapes except in chunks of ``_PAD``;
* the particle state on the device — unconstrained hyperparameters, log
  noise, cached masked LML, adaptive HMC step scales — with a leading
  particle axis;
* host mirrors of the trees (for structure proposals) and of the log
  importance weights (for ESS and resampling control flow);
* two random streams: ``rng``, a ``numpy.random.Generator`` for proposals
  and resampling, seeded exactly as the JAX package seeds its own, so
  initial particles, proposals and resample indices are bitwise equal for
  the same seed; and ``_gen``, a ``torch.Generator`` on the device for HMC
  and MH accept draws, seeded from the same ``SeedSequence``.

The time axis is normalised to [0, 1] over the *initial* window and the
targets are standardised; data added later extends beyond 1.  The ``config``
object is stored by reference.
"""

from __future__ import annotations

import copy
import hashlib

import numpy as np
import torch

from ..inference.device_smc import rejuvenation_sweep
from ..inference.hmc import run_hmc
from ..inference.resample import ess, gather_particles, resample_indices
from ..inference.structure_mcmc import mcmc_structure_sweep
from ..ops.lml import DEFAULT_JITTER, gp_lml_batched, gp_predict_batch
from ..utils.dates import as_date_array, dates_to_float
from ..utils.profiling import readback
from .config import GPConfig, HMCConfig
from .posterior import MvNormalMixture
from .structures import prior_arrays, sample_particle
from .structures_device import ancestor_table, config_arrays

__all__ = ["GPModel", "num_particles", "normalized_weights", "predict_mvn",
           "add_data", "maybe_resample", "mcmc_structure", "mcmc_parameters",
           "threefry_key_data", "key_seed"]

# Capacity granule for the fixed-shape data buffers; the LML kernels take
# n % 32 == 0.
_PAD = 32
DTYPE = torch.float32


def _pad_to(arr: np.ndarray, cap: int, fill=0.0) -> np.ndarray:
    out = np.full(cap, fill, dtype=np.float32)
    out[: arr.shape[0]] = arr
    return out


def _seeded_generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def threefry_key_data(seed: int) -> np.ndarray:
    """The key data of the JAX package's ``jax.random.PRNGKey(seed)`` for a
    32-bit seed (the default threefry implementation): ``[0, seed]`` as
    uint32."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def key_seed(key) -> int:
    """The torch generator seed the port derives from JAX key data: the
    first 8 bytes of the SHA-256 of its uint32 words (the two generators
    produce different streams, so only the derivation is shared)."""
    key = np.ascontiguousarray(np.asarray(key, dtype=np.uint32))
    return int.from_bytes(hashlib.sha256(key.tobytes()).digest()[:8],
                          "little")


class GPModel:
    """Particle ensemble GP over a single time series."""

    def __init__(self, ds_or_dict, y=None, *, n_particles: int = 1,
                 config: GPConfig | None = None, seed: int | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        if isinstance(ds_or_dict, dict) and y is None:
            self._init_from_dict(ds_or_dict)
            return
        ds = ds_or_dict
        config = config if config is not None else GPConfig()
        self.config = config  # stored by reference (passthrough contract)
        self.ds = as_date_array(ds)
        self.y = np.asarray(list(y) if not isinstance(y, np.ndarray) else y,
                            dtype=np.float64)
        if len(self.ds) != len(self.y):
            raise ValueError("ds and y must have equal length")
        t_raw = dates_to_float(self.ds)

        # normalization over the initial window
        self._t0 = float(t_raw.min()) if t_raw.size else 0.0
        t_span = float(t_raw.max() - t_raw.min()) if t_raw.size else 1.0
        self._t_scale = t_span if t_span > 0 else 1.0
        self._y_mean = float(self.y.mean()) if self.y.size else 0.0
        y_std = float(self.y.std()) if self.y.size else 1.0
        self._y_std = y_std if y_std > 1e-12 else 1.0

        seed_seq = np.random.SeedSequence(seed)
        self.rng = np.random.default_rng(seed_seq)
        self._gen = _seeded_generator(self.device,
                                      seed_seq.generate_state(1)[0])

        # particle initialization from the structure + hyperparameter prior
        P = int(n_particles)
        types_l, params_l, noise_l = [], [], []
        for _ in range(P):
            t, p, ln = sample_particle(self.rng, config)
            types_l.append(t)
            params_l.append(p)
            noise_l.append(ln)
        self._host_types = np.stack(types_l).astype(np.int32)
        self._params_d = self._tensor(np.stack(params_l))
        self._log_noise_d = self._tensor(np.asarray(noise_l))
        self._lml_d = torch.zeros(P, dtype=DTYPE, device=self.device)
        self._eps_scale_d = torch.ones(P, dtype=DTYPE, device=self.device)
        self.log_weight = np.zeros(P, dtype=np.float64)

        # ingestion bookkeeping: device buffers hold data in ingestion order
        self._order = np.arange(len(self.y), dtype=np.int64)
        self.n_ingested = 0
        self._push_data()

    @classmethod
    def from_jax_state(cls, d: dict, device="cuda") -> "GPModel":
        """Build the port's model from the JAX package's ``GPModel.to_dict()``.

        ``d`` holds numpy arrays and a JAX-package ``GPConfig``; the config is
        rebuilt field by field, particle state and the numpy generator state
        carry over exactly, and the torch generator is seeded from a hash of
        the JAX key data (the two generators produce different streams).
        """
        cfg = d["config"]
        state = dict(d)
        state["config"] = GPConfig(
            node_dist_leaf=list(cfg.node_dist_leaf),
            node_dist_nocp=list(cfg.node_dist_nocp),
            node_dist_cp=list(cfg.node_dist_cp),
            changepoints=bool(cfg.changepoints), max_depth=int(cfg.max_depth),
            noise=cfg.noise, prior=copy.deepcopy(cfg.prior))
        dev = torch.device(device)
        state["device"] = str(dev)
        state["generator_state"] = (
            _seeded_generator(dev, key_seed(d["key"])).get_state().numpy())
        return cls(state)

    # ------------------------------------------------------------------ data

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=DTYPE, device=self.device)

    def _push_data(self):
        """(Re)build the fixed-capacity device buffers from host data."""
        n = len(self.y)
        cap = max(_PAD, int(np.ceil(max(n, 1) / _PAD)) * _PAD)
        t_raw = dates_to_float(self.ds)
        x_n = (t_raw - self._t0) / self._t_scale
        y_n = (self.y - self._y_mean) / self._y_std
        self._cap = cap
        self._x_d = self._tensor(_pad_to(x_n[self._order], cap))
        self._y_d = self._tensor(_pad_to(y_n[self._order], cap))

    def _mask(self, n: int | None = None) -> torch.Tensor:
        n = self.n_ingested if n is None else n
        return self._tensor((np.arange(self._cap) < n).astype(np.float32))

    def _batched_data(self, n: int | None = None, bucket: bool = False):
        """Particle-batched (x, y, mask) buffers, (P, cap) each.

        ``bucket=True`` returns the smallest sufficient ``_PAD``-multiple
        capacity for the conditioning set instead of the full buffer (the
        masked LML is invariant to trailing padding).
        """
        P = self.num_particles
        cap = self._cap
        if bucket:
            live = self.n_ingested if n is None else n
            cap = min(cap, max(_PAD, int(np.ceil(max(live, 1) / _PAD)) * _PAD))
        x = self._x_d[:cap].expand(P, cap)
        y = self._y_d[:cap].expand(P, cap)
        m = self._mask(n)[:cap].expand(P, cap)
        return x, y, m

    def _normalize_dates(self, ds) -> np.ndarray:
        return (dates_to_float(ds) - self._t0) / self._t_scale

    # ------------------------------------------------------------- properties

    @property
    def num_particles(self) -> int:
        return int(self._host_types.shape[0])

    @property
    def noise_prior(self):
        wc = self.config.prior["wildcard"]
        infer = 0.0 if self.config.noise is not None else 1.0
        return float(wc["mu"]) - 2.0, float(wc["sigma"]), infer

    def _types_d(self) -> torch.Tensor:
        return torch.as_tensor(self._host_types, dtype=torch.int32,
                               device=self.device)

    def structures(self) -> list[str]:
        """Human-readable kernel structures of all particles (diagnostics)."""
        from .structures import structure_to_str

        return [structure_to_str(t) for t in self._host_types]

    # ------------------------------------------------------------- inference

    def reweight_to(self, n_new: int):
        """Condition on data up to ``n_new`` ingestion slots (SMC reweight):
        weights are multiplied by the predictive likelihood of the newly
        ingested block."""
        x, y, m = self._batched_data(n_new, bucket=True)
        with torch.no_grad():
            lml_new = gp_lml_batched(self._types_d(), self._params_d,
                                     self._log_noise_d, x, y, m,
                                     DEFAULT_JITTER)
        lml_new_np = readback(lml_new).astype(np.float64)
        lml_old_np = readback(self._lml_d).astype(np.float64)
        # broken particles (LML at the -1e10 rejection sentinel) must lose
        # weight, not gain ~1e10 of it when only the old value is broken
        delta = np.where(
            (lml_old_np <= -1e9) | (lml_new_np <= -1e9), -1e10,
            lml_new_np - lml_old_np)
        self.log_weight += delta
        self._lml_d = lml_new
        self.n_ingested = n_new

    def resample(self, method: str = "systematic"):
        idx = resample_indices(self.rng, self.log_weight, method)
        idx_d = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        (self._params_d, self._log_noise_d, self._lml_d,
         self._eps_scale_d) = gather_particles(
            (self._params_d, self._log_noise_d, self._lml_d,
             self._eps_scale_d), idx_d)
        self._host_types = self._host_types[idx]
        self.log_weight = np.zeros_like(self.log_weight)
        return idx

    def rejuvenate(self, n_mcmc: int, n_hmc: int,
                   hmc_config: HMCConfig | None = None,
                   engine: str = "host"):
        """n_mcmc structure moves, each followed by n_hmc HMC trajectories;
        returns the mean structure acceptance.  ``engine="host"`` builds the
        proposals in numpy (one device call per move); ``"device"`` runs
        the sweep on the device (``inference/device_smc.py``)."""
        hmc_cfg = hmc_config or HMCConfig()
        noise_mu, noise_sigma, infer = self.noise_prior
        x, y, m = self._batched_data(bucket=True)
        if engine == "device":
            types, params, log_noise, lml, acc, scale = rejuvenation_sweep(
                self._types_d(), self._params_d, self._log_noise_d,
                self._lml_d, x, y, m, self._gen,
                config_arrays(self.config, self.device),
                torch.as_tensor(ancestor_table(self.config.max_nodes),
                                device=self.device),
                n_mcmc=int(n_mcmc), n_hmc=int(n_hmc),
                n_leapfrog=hmc_cfg.n_leapfrog, step_size=hmc_cfg.step_size,
                step_jitter=hmc_cfg.step_size_jitter, jitter=DEFAULT_JITTER,
                noise_mu=noise_mu, noise_sigma=noise_sigma, infer_noise=infer,
                eps_scale=self._eps_scale_d,
            )
            self._host_types = readback(types).astype(np.int32)
            self._params_d, self._log_noise_d = params, log_noise
            self._lml_d, self._eps_scale_d = lml, scale
            return float(acc)
        if engine != "host":
            raise ValueError(f"engine={engine!r}; expected 'host' or 'device'")
        (self._host_types, self._params_d, self._log_noise_d, self._lml_d,
         acc, self._eps_scale_d) = mcmc_structure_sweep(
            self.rng, self._gen, self._host_types, self._params_d,
            self._log_noise_d, self._lml_d, x, y, m, self.config,
            int(n_mcmc), int(n_hmc), hmc_cfg, DEFAULT_JITTER, noise_mu,
            noise_sigma, infer, self._eps_scale_d,
        )
        return acc

    def hmc_only(self, n_hmc: int, hmc_config: HMCConfig | None = None):
        """Parameter-only rejuvenation (AutoGP.mcmc_parameters! semantics)."""
        hmc_cfg = hmc_config or HMCConfig()
        noise_mu, noise_sigma, infer = self.noise_prior
        x, y, m = self._batched_data(bucket=True)
        mu, sigma, active = (self._tensor(a) for a in
                             prior_arrays(self._host_types, self.config))
        (self._params_d, self._log_noise_d, self._lml_d, rate,
         self._eps_scale_d, _) = run_hmc(
            self._types_d(), self._params_d, self._log_noise_d,
            mu, sigma, active, x, y, m, self._gen,
            n_steps=int(n_hmc), n_leapfrog=hmc_cfg.n_leapfrog,
            step_size=hmc_cfg.step_size, step_jitter=hmc_cfg.step_size_jitter,
            jitter=DEFAULT_JITTER, noise_mu=noise_mu, noise_sigma=noise_sigma,
            infer_noise=infer, eps_scale=self._eps_scale_d,
        )
        return float(rate.mean())

    # -------------------------------------------------------------- serialize

    def to_dict(self) -> dict:
        """Full ensemble state -> plain dict of numpy arrays.

        The keys are the JAX package's, with the JAX key replaced by the
        torch generator's state and the device it belongs to.
        """
        def host(t):
            return t.detach().cpu().numpy().copy()

        return {
            "version": 1,
            "ds": self.ds,
            "y": self.y.copy(),
            "order": self._order.copy(),
            "n_ingested": int(self.n_ingested),
            "t0": self._t0, "t_scale": self._t_scale,
            "y_mean": self._y_mean, "y_std": self._y_std,
            "node_types": self._host_types.copy(),
            "params": host(self._params_d),
            "log_noise": host(self._log_noise_d),
            "lml": host(self._lml_d),
            "log_weight": self.log_weight.copy(),
            "hmc_eps_scale": host(self._eps_scale_d),
            "config": self.config,
            "rng_state": self.rng.bit_generator.state,
            "device": str(self.device),
            "generator_state": self._gen.get_state().numpy().copy(),
        }

    def _init_from_dict(self, d: dict):
        self.device = torch.device(d["device"])
        self.config = d["config"]
        self.ds = d["ds"]
        self.y = np.asarray(d["y"], dtype=np.float64)
        self._order = np.asarray(d["order"], dtype=np.int64)
        self.n_ingested = int(d["n_ingested"])
        self._t0 = float(d["t0"])
        self._t_scale = float(d["t_scale"])
        self._y_mean = float(d["y_mean"])
        self._y_std = float(d["y_std"])
        self._host_types = np.asarray(d["node_types"], dtype=np.int32)
        self._params_d = self._tensor(d["params"])
        self._log_noise_d = self._tensor(d["log_noise"])
        self._lml_d = self._tensor(d["lml"])
        self.log_weight = np.asarray(d["log_weight"], dtype=np.float64)
        scale = d.get("hmc_eps_scale")
        self._eps_scale_d = (
            self._tensor(scale) if scale is not None
            else torch.ones(self._host_types.shape[0], dtype=DTYPE,
                            device=self.device))
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = copy.deepcopy(d["rng_state"])
        self._gen = torch.Generator(device=self.device)
        self._gen.set_state(torch.as_tensor(d["generator_state"],
                                            dtype=torch.uint8))
        self._push_data()

    def clone(self) -> "GPModel":
        return GPModel(copy.deepcopy(self.to_dict()))


# ---------------------------------------------------------------- module API


def num_particles(model: GPModel) -> int:
    """Ensemble size (AutoGP.num_particles)."""
    return model.num_particles


def normalized_weights(model: GPModel) -> np.ndarray:
    """Normalized importance weights of the particle ensemble (float64)."""
    lw = model.log_weight - model.log_weight.max()
    w = np.exp(lw)
    return w / w.sum()


def predict_mvn(model: GPModel, ds, *,
                include_noise: bool = True) -> MvNormalMixture:
    """Predictive posterior at ``ds`` as a weighted mixture over particles,
    on the transformed-data scale (``AutoGP.predict_mvn`` semantics).  The
    moments are computed on ``model.device`` over the full data buffer."""
    xs = model._tensor(model._normalize_dates(ds))
    x, y, m = model._batched_data()
    with torch.no_grad():
        mu, cov = gp_predict_batch(
            model._types_d(), model._params_d, model._log_noise_d, x, y, m,
            xs, DEFAULT_JITTER, include_noise)
    w = normalized_weights(model)
    mu = model._y_mean + model._y_std * readback(mu).astype(np.float64)
    cov = (model._y_std**2) * readback(cov).astype(np.float64)
    return MvNormalMixture(w, mu, cov)


def add_data(model: GPModel, ds, y) -> None:
    """Incrementally condition on new observations (SMC reweighting), the
    semantics of ``AutoGP.add_data!``."""
    ds_new = as_date_array(ds)
    y_new = np.asarray(list(y) if not isinstance(y, np.ndarray) else y,
                       dtype=np.float64)
    if len(ds_new) != len(y_new):
        raise ValueError("ds and y must have equal length")
    if len(y_new) == 0:
        return
    n_old = len(model.y)
    if model.ds.dtype == object:
        merged = np.empty(n_old + len(ds_new), dtype=object)
        merged[:n_old] = model.ds
        merged[n_old:] = list(ds_new)
        model.ds = merged
    else:
        model.ds = np.concatenate([model.ds, ds_new.astype(model.ds.dtype)])
    model.y = np.concatenate([model.y, y_new])
    # splice the new rows into the ingestion order at position n_ingested so
    # the extended mask covers exactly the new block
    new_idx = np.arange(n_old, n_old + len(y_new), dtype=np.int64)
    k = model.n_ingested
    model._order = np.concatenate([model._order[:k], new_idx, model._order[k:]])
    model._push_data()
    model.reweight_to(k + len(y_new))


def maybe_resample(model: GPModel, threshold: float) -> bool:
    """Resample the ensemble if ESS < threshold (in particle counts;
    ``AutoGP.maybe_resample!`` semantics)."""
    if threshold <= 0:
        return False
    if ess(model.log_weight) < float(threshold):
        model.resample()
        return True
    return False


def mcmc_structure(model: GPModel, n_mcmc: int, n_hmc: int,
                   hmc_config: HMCConfig | None = None) -> float:
    """Structure + hyperparameter rejuvenation of all particles
    (``AutoGP.mcmc_structure!``)."""
    return model.rejuvenate(int(n_mcmc), int(n_hmc), hmc_config)


def mcmc_parameters(model: GPModel, n_hmc: int,
                    hmc_config: HMCConfig | None = None) -> float:
    """HMC-only hyperparameter rejuvenation (``AutoGP.mcmc_parameters!``)."""
    return model.hmc_only(int(n_hmc), hmc_config)
