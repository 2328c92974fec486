"""Device-proposal SMC: structure moves, accepts and resampling on the card.

Port of the JAX package's ``inference/device_smc.py``.  With the tree
surgery on the device (``models/structures_device.py``), the whole engine
step -- data-annealed reweighting, the ESS-gated resample, involutive
structure moves with MH accepts, and HMC rejuvenation -- is a sequence of
batched tensor calls.  The JAX package compiles it into one ``lax.scan``;
here ``smc_fit_device`` is a Python loop over schedule steps and moves, and
every decision stays on the device as a tensor: the MH accept, the ESS
gate and the resample are ``torch.where`` selects, so the host queues work
and never reads a value back inside the loop.  The one exception is
``adaptive=True``, which reads the ESS gate once per schedule step to skip
a sweep that would be discarded.

Semantics match ``inference/smc.py``'s host engine: the default mode
rejuvenates every step and resamples when the ESS drops below
``ess_frac`` x P; ``adaptive`` only rejuvenates after a resample.
"""

from __future__ import annotations

import torch

from ..models.structures_device import (
    ConfigArrays, device_prior_arrays, device_propose_mixed,
)
from ..ops.lml import DEFAULT_JITTER, gp_lml_batched
from .hmc import _value_and_grad, make_batched_potential, run_hmc

__all__ = ["rejuvenation_sweep", "smc_fit_device"]


def rejuvenation_sweep(
    types, params, log_noise, lml, x, y, mask, gen, cfg: ConfigArrays, anc,
    *, n_mcmc, n_hmc, n_leapfrog, step_size, step_jitter,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
    eps_scale=None,
):
    """``n_mcmc`` involutive moves, each followed by ``n_hmc`` HMC
    trajectories, for all particles.  Every tensor carries the particle
    axis, the data rows ``x``/``y``/``mask`` included (``mask`` may be one
    shared row).

    With ``n_hmc > 0`` a proposal is evaluated with the value and gradient
    of the HMC potential (one K1 launch on the card) instead of the value
    alone: the accept test uses its LML, and its gradient is the next HMC's
    initial gradient for accepted particles, while rejected particles keep
    the gradient carried out of the previous HMC.  Each carried quantity is
    the same function at the same point as the recomputation it replaces.

    Returns (types, params, log_noise, lml, mean accept rate (0-d tensor),
    eps_scale).
    """
    P = params.shape[0]
    dev = params.device
    n_mcmc, n_hmc = int(n_mcmc), int(n_hmc)
    if eps_scale is None:
        eps_scale = torch.ones(P, dtype=params.dtype, device=dev)
    mask = mask.expand(x.shape)
    hmc_kw = dict(
        n_steps=n_hmc, n_leapfrog=n_leapfrog, step_size=step_size,
        step_jitter=step_jitter, jitter=jitter, noise_mu=noise_mu,
        noise_sigma=noise_sigma, infer_noise=infer_noise)

    def pot_and_grad_at(t, p, ln):
        mu, sg, act = device_prior_arrays(t, cfg)
        potential = make_batched_potential(
            t, mu, sg, act, x, y, mask, jitter,
            noise_mu, noise_sigma, infer_noise)
        return _value_and_grad(potential, p, ln)

    if n_hmc > 0:
        # one evaluation at the current state seeds the carried potential
        # and gradients for the whole sweep
        U, lml, g_p, g_n = pot_and_grad_at(types, params, log_noise)
    n_acc = torch.zeros(P, device=dev)
    for _ in range(n_mcmc):
        t2, p2, log_h = device_propose_mixed(types, params, gen, cfg, anc)
        if n_hmc > 0:
            U2, lml2, g2_p, g2_n = pot_and_grad_at(t2, p2, log_noise)
        else:
            with torch.no_grad():
                lml2 = gp_lml_batched(t2, p2, log_noise, x, y, mask, jitter)
        u = torch.rand(P, generator=gen, device=dev)
        accept = torch.log(u) < (lml2 - lml + log_h)
        a1, a3 = accept[:, None], accept[:, None, None]
        types = torch.where(a1, t2, types)
        params = torch.where(a3, p2, params)
        lml = torch.where(accept, lml2, lml)
        if n_hmc > 0:
            U = torch.where(accept, U2, U)
            g_p = torch.where(a3, g2_p, g_p)
            g_n = torch.where(accept, g2_n, g_n)
            mu, sg, act = device_prior_arrays(types, cfg)
            params, log_noise, lml, _, eps_scale, (U, g_p, g_n) = (
                run_hmc(types, params, log_noise, mu, sg, act, x, y, mask,
                        gen, eps_scale=eps_scale, init=(U, lml, g_p, g_n),
                        **hmc_kw))
        n_acc = n_acc + accept.to(n_acc.dtype)
    return (types, params, log_noise, lml,
            n_acc.mean() / max(n_mcmc, 1), eps_scale)


def smc_fit_device(
    types, params, log_noise, log_w, lml, eps_scale, x, y, masks, gen, cfg,
    anc, *,
    n_mcmc, n_hmc, n_leapfrog, step_size, step_jitter, adaptive,
    biased=False, ess_frac=0.5, jitter=DEFAULT_JITTER, noise_mu=-2.0,
    noise_sigma=1.0, infer_noise=1.0,
):
    """The data-annealed SMC fit over the schedule steps of ``masks``.

    types int32 (P, N); params float32 (P, N, 3); log_noise, log_w, lml
    float32 (P,); x/y float32 (P, cap) per-particle rows; masks float32
    (K, cap) or (K, P, cap), one ingestion mask per schedule step.

    Returns (types, params, log_noise, log_w, lml, eps_scale, diagnostics)
    with diagnostics = (ess (K,), struct_accept (K,), resampled (K,)),
    tensors on the device.
    """
    P = params.shape[0]
    dev = params.device
    iota = torch.arange(P, device=dev)
    ess_l, acc_l, low_l = [], [], []
    for mask_k in masks:
        mask_k = mask_k.expand(x.shape)
        # (1) reweight to this step's conditioning set.  A particle broken
        # on either side (LML at the -1e10 sentinel) must lose its weight,
        # not gain ~1e10 of it when only the old value is broken.
        with torch.no_grad():
            lml_new = gp_lml_batched(types, params, log_noise, x, y, mask_k,
                                     jitter)
        delta = torch.where((lml <= -1e9) | (lml_new <= -1e9),
                            torch.full_like(lml, -1e10), lml_new - lml)
        log_w = log_w + delta
        lml = lml_new

        # (2) ESS and the resample, selected on the device
        w = torch.exp(log_w - torch.logsumexp(log_w, 0))
        ess = 1.0 / (w * w).sum()
        low = ess < ess_frac * P
        if biased:
            idx_res = torch.multinomial(w, P, replacement=True, generator=gen)
        else:
            u = torch.rand((), generator=gen, device=dev)
            positions = (u + iota.to(w.dtype)) / P
            idx_res = torch.searchsorted(torch.cumsum(w, 0),
                                         positions).clamp(0, P - 1)
        idx = torch.where(low, idx_res, iota)
        types, params, log_noise, lml, eps_scale, x, y = (
            a[idx] for a in (types, params, log_noise, lml, eps_scale, x, y))
        log_w = torch.where(low, torch.zeros_like(log_w), log_w)

        # (3) rejuvenation: every step, or only after a resample
        if not adaptive or bool(low):
            types, params, log_noise, lml, acc, eps_scale = (
                rejuvenation_sweep(
                    types, params, log_noise, lml, x, y, mask_k, gen, cfg,
                    anc, n_mcmc=n_mcmc, n_hmc=n_hmc, n_leapfrog=n_leapfrog,
                    step_size=step_size, step_jitter=step_jitter,
                    jitter=jitter, noise_mu=noise_mu,
                    noise_sigma=noise_sigma, infer_noise=infer_noise,
                    eps_scale=eps_scale))
        else:
            acc = torch.zeros((), device=dev)
        ess_l.append(ess)
        acc_l.append(acc)
        low_l.append(low)
    diag = tuple(torch.stack(d) for d in (ess_l, acc_l, low_l))
    return types, params, log_noise, log_w, lml, eps_scale, diag
