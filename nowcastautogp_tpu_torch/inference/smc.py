"""Data-annealed SMC over kernel structures and hyperparameters.

Port of the JAX package's ``inference/smc.py`` host loop: anneal over data
batches given by a schedule; after each reweight step, resample when the
ESS drops below ``ess_fraction`` of the ensemble and rejuvenate every
particle with ``n_mcmc`` involutive structure moves x ``n_hmc`` HMC
trajectories.  ``adaptive_rejuvenation=True`` only rejuvenates after a
resample.  ``shuffle=True`` randomises the data-ingestion order once up
front (the GP likelihood is exchangeable given the time stamps).

The Python loop is control flow over O(P) scalars; every numerical step
(reweight LML, accept, HMC, resample gather) is a batched tensor call on the
model's device.  Reweights and rejuvenation run on the smallest ``_PAD``
multiple of the data buffer that holds the conditioning set (capacity
bucketing: the masked LML is invariant to trailing padding).
"""

from __future__ import annotations

import logging
import time

from ..models.config import HMCConfig
from .resample import ess

__all__ = ["fit_smc"]

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
    selects multinomial resampling instead of systematic.  Only the host
    engine is ported: ``engine="device"`` raises.
    """
    if engine != "host":
        raise NotImplementedError(
            f"engine={engine!r}: the device-proposal SMC engine is not ported "
            "yet (ROADMAP.md, modules to port: device proposals, "
            "models/structures_device.py and inference/device_smc.py)")
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
    t_start = time.time()
    for step_i, n_k in enumerate(schedule):
        model.reweight_to(int(n_k))
        e = ess(model.log_weight)
        low_ess = e < ess_fraction * P
        do_rejuvenate = low_ess if adaptive_rejuvenation else True
        if low_ess:
            model.resample(method)
        acc = None
        if do_rejuvenate:
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

