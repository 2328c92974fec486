"""Data-annealed SMC over kernel structures and hyperparameters.

Port of the JAX package's ``inference/smc.py``: anneal over data
batches given by a schedule; after each reweight step, resample when the
ESS drops below ``ess_fraction`` of the ensemble and rejuvenate every
particle with ``n_mcmc`` involutive structure moves x ``n_hmc`` HMC
trajectories.  ``adaptive_rejuvenation=True`` only rejuvenates after a
resample.  ``shuffle=True`` randomises the data-ingestion order once up
front (the GP likelihood is exchangeable given the time stamps).

Two engines.  ``engine="host"`` (the port's default) is the host loop:
control flow over O(P) scalars, numpy structure proposals, and every
numerical step (reweight LML, accept, HMC, resample gather) a batched
tensor call on the model's device.  ``engine="device"`` runs the whole loop
through ``inference/device_smc.py``: proposals, accepts, the ESS gate and
the resample stay on the device and the host reads the state back once per
capacity segment.  Both run reweights and rejuvenation on the smallest
``_PAD`` multiple of the data buffer that holds the conditioning set
(capacity bucketing: the masked LML is invariant to trailing padding).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..models.config import HMCConfig
from ..models.gp_model import _PAD
from ..models.structures_device import ancestor_table, config_arrays
from ..utils.profiling import phase
from .device_smc import smc_fit_device
from .resample import ess

__all__ = ["fit_smc", "schedule_segments"]

logger = logging.getLogger("nowcastautogp_tpu_torch")


def fit_smc(
    model, *, schedule, n_mcmc, n_hmc,
    hmc_config: HMCConfig | None = None,
    biased: bool = False,
    shuffle: bool = True,
    verbose: bool = False,
    adaptive_rejuvenation: bool = False,
    ess_fraction: float = 0.5,
    engine: str = "host",
):
    """Fit the particle ensemble by data-annealed SMC (mutates ``model``).

    ``n_mcmc``/``n_hmc`` are required keyword arguments.  ``biased=True``
    selects multinomial resampling instead of systematic.  ``engine`` is
    ``"host"`` (host proposals, the default) or ``"device"`` (module
    docstring).
    """
    if engine not in ("host", "device"):
        raise ValueError(f"engine={engine!r}; expected 'host' or 'device'")
    n_mcmc = int(n_mcmc)
    n_hmc = int(n_hmc)
    hmc_cfg = hmc_config or HMCConfig()
    P = model.num_particles
    method = "multinomial" if biased else "systematic"

    n = len(model.y)
    if shuffle and n > 1:
        model._order = model.rng.permutation(n).astype(model._order.dtype)
        model._push_data()

    schedule = [s for s in schedule if s > model.n_ingested]
    if engine == "device" and schedule:
        return _fit_device(model, schedule, n_mcmc, n_hmc, hmc_cfg,
                           adaptive_rejuvenation, ess_fraction, verbose,
                           biased)
    t_start = time.time()
    for step_i, n_k in enumerate(schedule):
        with phase("smc/reweight"):
            model.reweight_to(int(n_k))
            e = ess(model.log_weight)
        low_ess = e < ess_fraction * P
        do_rejuvenate = low_ess if adaptive_rejuvenation else True
        if low_ess:
            with phase("smc/resample"):
                model.resample(method)
        acc = None
        if do_rejuvenate:
            with phase("smc/rejuvenate"):
                if n_mcmc > 0:
                    acc = model.rejuvenate(n_mcmc, n_hmc, hmc_cfg)
                elif n_hmc > 0:
                    acc = model.hmc_only(n_hmc, hmc_cfg)
        if verbose:
            logger.info(
                "SMC step %d/%d: n=%d ESS=%.1f/%d resampled=%s "
                "struct-accept=%s elapsed=%.1fs",
                step_i + 1, len(schedule), n_k, e, P, low_ess,
                f"{acc:.2f}" if acc is not None else "-", time.time() - t_start,
            )
    return model


def schedule_segments(schedule, cap_full):
    """Group consecutive schedule steps by the smallest sufficient
    ``_PAD``-multiple capacity: ``[(cap, [n_k, ...]), ...]``."""
    segments: list[tuple[int, list[int]]] = []
    for n_k in schedule:
        cap_k = min(cap_full, max(_PAD, int(np.ceil(n_k / _PAD)) * _PAD))
        if segments and segments[-1][0] == cap_k:
            segments[-1][1].append(int(n_k))
        else:
            segments.append((cap_k, [int(n_k)]))
    return segments


def _fit_device(model, schedule, n_mcmc, n_hmc, hmc_cfg,
                adaptive_rejuvenation, ess_fraction, verbose, biased):
    """The device engine's fit (mutates ``model``): one
    ``smc_fit_device`` call per capacity segment of the schedule, the
    particle state kept on the device in between."""
    P = model.num_particles
    dev = model.device
    noise_mu, noise_sigma, infer = model.noise_prior
    cfg = config_arrays(model.config, dev)
    anc = torch.as_tensor(ancestor_table(model.config.max_nodes), device=dev)
    state = (model._types_d(), model._params_d, model._log_noise_d,
             model._tensor(model.log_weight), model._lml_d,
             model._eps_scale_d)
    t0 = time.time()
    step_base = 0
    for cap_seg, steps in schedule_segments(schedule, model._cap):
        iota = np.arange(cap_seg)
        masks = model._tensor(np.stack(
            [(iota < n_k).astype(np.float32) for n_k in steps]))
        x = model._x_d[:cap_seg].expand(P, cap_seg)
        y = model._y_d[:cap_seg].expand(P, cap_seg)
        with phase("smc/device_fit"):
            *state, diag = smc_fit_device(
                *state, x, y, masks, model._gen, cfg, anc,
                n_mcmc=n_mcmc, n_hmc=n_hmc, n_leapfrog=hmc_cfg.n_leapfrog,
                step_size=hmc_cfg.step_size,
                step_jitter=hmc_cfg.step_size_jitter,
                adaptive=bool(adaptive_rejuvenation), biased=bool(biased),
                ess_frac=float(ess_fraction), noise_mu=noise_mu,
                noise_sigma=noise_sigma, infer_noise=infer,
            )
        if verbose:
            ess_s, acc_s, low_s = (d.cpu().numpy() for d in diag)
            for i, n_k in enumerate(steps):
                logger.info(
                    "SMC step %d/%d: n=%d cap=%d ESS=%.1f/%d resampled=%s "
                    "struct-accept=%.2f elapsed(total)=%.1fs",
                    step_base + i + 1, len(schedule), n_k, cap_seg, ess_s[i],
                    P, bool(low_s[i]), acc_s[i], time.time() - t0)
        step_base += len(steps)
    types, params, log_noise, log_w, lml, eps_scale = state
    model._host_types = types.cpu().numpy().astype(np.int32)
    model._params_d, model._log_noise_d = params, log_noise
    model._lml_d, model._eps_scale_d = lml, eps_scale
    model.log_weight = log_w.cpu().numpy().astype(np.float64)
    model.n_ingested = int(schedule[-1])
    return model
