"""Involutive-MCMC kernel-structure moves: host proposals, batched accept.

Port of the JAX package's ``inference/structure_mcmc.py`` host engine.
Structure proposals (random scan over subtree regeneration, leaf-type swap
and birth/death) are irregular and run on the host in numpy for all
particles at once, drawing from the same ``numpy.random.Generator`` stream as
the JAX package.  One batched call then evaluates every proposal's masked
LML (K2 on the card), applies the MH accept, selects the surviving trees and
params, and runs ``n_hmc`` HMC trajectories on the winners.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import GPConfig
from ..models.structures import (
    prior_arrays, propose_birth_death, propose_leaf_swap,
    propose_subtree_replace,
)
# mixture weights of the three involutive moves, shared with the device
# proposals: subtree regeneration, leaf-type swap, birth/death
from ..models.structures_device import MOVE_PROBS
from ..ops.lml import gp_lml_batched
from ..utils.profiling import readback, span
from .hmc import run_hmc

__all__ = ["MOVE_PROBS", "propose_batch", "mcmc_structure_sweep"]


def propose_batch(rng: np.random.Generator, node_types: np.ndarray,
                  params: np.ndarray, config: GPConfig):
    """Structure proposals for every particle (host side).

    node_types: int32[P, N]; params: f32[P, N, 3].  Returns proposed trees,
    proposed params, per-particle log-Hastings corrections, and the proposal
    prior arrays for the HMC log-posterior.
    """
    with span("mcmc/propose"):
        P = node_types.shape[0]
        new_types = np.empty_like(node_types)
        new_params = np.empty_like(params)
        log_h = np.empty(P, dtype=np.float32)
        for i in range(P):
            r = rng.random()
            if r < MOVE_PROBS[0]:
                move = propose_subtree_replace
            elif r < MOVE_PROBS[0] + MOVE_PROBS[1]:
                move = propose_leaf_swap
            else:
                move = propose_birth_death
            t2, p2, lh = move(rng, node_types[i], params[i], config)
            new_types[i] = t2
            new_params[i] = p2
            log_h[i] = lh
        pri = prior_arrays(new_types, config)
        return new_types, new_params, log_h, pri


def _structure_move_body(
    types_old, types_prop, params_old, params_prop,
    pri_old, pri_prop, log_hastings, log_noise, lml_old,
    x, y, mask, gen, eps_scale, *,
    n_hmc, n_leapfrog, step_size, step_jitter,
    jitter, noise_mu, noise_sigma, infer_noise,
):
    """Proposal LML -> MH accept -> select -> HMC, for all particles.

    Returns (accept, types, params, log_noise, lml, hmc accept rate (P,),
    eps_scale).
    """
    with span("mcmc/accept"):
        P = params_old.shape[0]
        with torch.no_grad():
            lml_prop = gp_lml_batched(types_prop, params_prop, log_noise, x, y,
                                      mask, jitter)
        logit = lml_prop - lml_old + log_hastings
        u = torch.rand(P, generator=gen, device=params_old.device)
        accept = torch.log(u) < logit
        a1, a3 = accept[:, None], accept[:, None, None]
        types = torch.where(a1, types_prop, types_old)
        params = torch.where(a3, params_prop, params_old)
        mu, sigma, active = (torch.where(a3, new, old)
                             for new, old in zip(pri_prop, pri_old))
        lml = torch.where(accept, lml_prop, lml_old)
    rate = torch.zeros(P, dtype=params.dtype, device=params.device)
    if n_hmc > 0:
        params, log_noise, lml, rate, eps_scale, _ = run_hmc(
            types, params, log_noise, mu, sigma, active, x, y, mask, gen,
            n_steps=n_hmc, n_leapfrog=n_leapfrog, step_size=step_size,
            step_jitter=step_jitter, jitter=jitter, noise_mu=noise_mu,
            noise_sigma=noise_sigma, infer_noise=infer_noise,
            eps_scale=eps_scale,
        )
    return accept, types, params, log_noise, lml, rate, eps_scale


def mcmc_structure_sweep(
    rng, gen, host_types, params, log_noise, lml, x, y, mask,
    config: GPConfig, n_mcmc: int, n_hmc: int, hmc_cfg, jitter,
    noise_mu, noise_sigma, infer_noise, eps_scale,
):
    """Run ``n_mcmc`` structure moves, each followed by ``n_hmc`` HMC
    trajectories.

    ``host_types`` is the host-side numpy mirror of the trees (the host owns
    structure state so it can build the next proposal).  Returns
    ``(host_types, params, log_noise, lml, mean accept rate, eps_scale)``.
    """
    dev = params.device

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    pri_old = prior_arrays(host_types, config)
    accepts = []
    for _ in range(n_mcmc):
        with span("mcmc/move"):
            types_prop, params_prop, log_h, pri_prop = propose_batch(
                rng, host_types, readback(params), config)
            accept, _, params, log_noise, lml, _, eps_scale = (
                _structure_move_body(
                    on_dev(host_types, torch.int32),
                    on_dev(types_prop, torch.int32),
                    params, on_dev(params_prop),
                    tuple(map(on_dev, pri_old)), tuple(map(on_dev, pri_prop)),
                    on_dev(log_h), log_noise, lml, x, y, mask, gen, eps_scale,
                    n_hmc=n_hmc, n_leapfrog=hmc_cfg.n_leapfrog,
                    step_size=hmc_cfg.step_size,
                    step_jitter=hmc_cfg.step_size_jitter,
                    jitter=jitter, noise_mu=noise_mu, noise_sigma=noise_sigma,
                    infer_noise=infer_noise,
                ))
            acc_np = readback(accept)
            host_types = np.where(acc_np[:, None], types_prop,
                                  host_types).astype(np.int32)
            pri_old = tuple(np.where(acc_np[:, None, None], pn, po)
                            for pn, po in zip(pri_prop, pri_old))
            accepts.append(acc_np.mean())
    return (host_types, params, log_noise, lml,
            float(np.mean(accepts)) if accepts else 0.0, eps_scale)
