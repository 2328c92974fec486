"""Batched HMC over per-particle GP hyperparameters.

Port of the JAX package's ``inference/hmc.py``: ``make_batched_potential``
and ``run_hmc`` (its ``_hmc_batched``, with the carried state exposed).
Every tensor carries the leading particle axis, data buffers included.
Inactive parameter slots (empty heap nodes, unused parameter slots) get
zero momentum and zero gradient, so heterogeneous
structures share one batched call.  The potential's value and gradient are
carried across trajectories: a trajectory costs exactly ``n_leapfrog``
gradient evaluations, each one K1 launch on the card.

Randomness (step jitter, momenta, accepts) comes from the ``torch.Generator``
the caller owns; each leapfrog differentiates a fresh leaf tensor, so
autograd graphs never outlive one evaluation.
"""

from __future__ import annotations

import torch

from ..ops.lml import gp_lml_batched
from ..utils.profiling import span

__all__ = ["make_batched_potential", "run_hmc"]

# Robbins-Monro adaptation of the per-particle step-size scale: nudge the
# scale after every trajectory toward this target acceptance rate.  The scale
# persists in the model state, so adaptation accumulates across a fit.
_TARGET_ACCEPT = 0.65
_ADAPT_RATE = 0.05
_SCALE_BOUNDS = (0.02, 50.0)


def make_batched_potential(
    node_types, prior_mu, prior_sigma, prior_active,
    x, y, mask, jitter, noise_mu, noise_sigma, infer_noise,
):
    """Batched HMC potential ``(params, log_noise) -> (U, lml)``, each (P,).

    The summed potential decouples into per-particle gradients.
    """
    log_sigma = torch.log(prior_sigma)

    def potential(p, ln):
        lml = gp_lml_batched(node_types, p, ln, x, y, mask, jitter)
        z = (p - prior_mu) / prior_sigma
        lp = (prior_active * (-0.5 * z * z - log_sigma)).sum((1, 2))
        zn = (ln - noise_mu) / noise_sigma
        lp = lp + infer_noise * (-0.5 * zn * zn)
        return -(lml + lp), lml

    return potential


def _value_and_grad(potential, p, ln):
    """(U, lml, dU/dp, dU/dln) at (p, ln), with no graph left behind."""
    with span("lml/grad"):
        p = p.detach().requires_grad_(True)
        ln = ln.detach().requires_grad_(True)
        with torch.enable_grad():
            U, lml = potential(p, ln)
            g_p, g_n = torch.autograd.grad(U.sum(), (p, ln))
        return U.detach(), lml.detach(), g_p, g_n


def run_hmc(
    node_types, params, log_noise, prior_mu, prior_sigma, prior_active,
    x, y, mask, gen, *, n_steps, n_leapfrog, step_size, step_jitter,
    jitter, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0, eps_scale=None,
    init=None,
):
    """``n_steps`` HMC trajectories for all particles, with the carried
    state exposed (the JAX package's ``_hmc_batched``).

    ``init``, when given, is ``(U0, lml0, g_p0, g_n0)``: the potential, LML
    and gradients already evaluated at ``(params, log_noise)``, and the
    initial evaluation is skipped (the device sweep carries them across
    moves).  Returns ``(params, log_noise, lml, accept_rate (P,), eps_scale,
    (U, g_p, g_n))``, the last the final state's potential and gradients,
    valid for the same carrying.
    """
    with span("hmc/run"):
        P = params.shape[0]
        dev = params.device
        if eps_scale is None:
            eps_scale = torch.ones(P, dtype=params.dtype, device=dev)
        potential = make_batched_potential(
            node_types, prior_mu, prior_sigma, prior_active,
            x, y, mask, jitter, noise_mu, noise_sigma, infer_noise,
        )
        if init is None:
            U0, lml, g_p, g_n = _value_and_grad(potential, params, log_noise)
        else:
            U0, lml, g_p, g_n = init
        p, ln, scale = params.detach(), log_noise.detach(), eps_scale
        n_acc = torch.zeros(P, dtype=torch.float32, device=dev)
        for _ in range(n_steps):
            with span("hmc/trajectory"):
                eps = step_size * scale * (
                    1.0 + step_jitter * (
                        2.0 * torch.rand(P, generator=gen, device=dev) - 1.0))
                eps3 = eps[:, None, None]
                mom_p = torch.randn(p.shape, generator=gen,
                                    device=dev) * prior_active
                mom_n = torch.randn(P, generator=gen, device=dev) * infer_noise
                K0 = 0.5 * ((mom_p * mom_p).sum((1, 2)) + mom_n * mom_n)

                p_, ln_, mp, mn, gp_, gn_ = p, ln, mom_p, mom_n, g_p, g_n
                U_, lml_ = U0, lml
                for _ in range(n_leapfrog):
                    mp = mp - 0.5 * eps3 * gp_ * prior_active
                    mn = mn - 0.5 * eps * gn_ * infer_noise
                    p_ = p_ + eps3 * mp * prior_active
                    ln_ = ln_ + eps * mn * infer_noise
                    U_, lml_, gp_, gn_ = _value_and_grad(potential, p_, ln_)
                    mp = mp - 0.5 * eps3 * gp_ * prior_active
                    mn = mn - 0.5 * eps * gn_ * infer_noise
                K1 = 0.5 * ((mp * mp).sum((1, 2)) + mn * mn)
                dH = (U0 + K0) - (U_ + K1)
                u = torch.rand(P, generator=gen, device=dev)
                ok = torch.isfinite(dH) & (
                    torch.log(u) < torch.clamp_max(dH, 0.0))
                ok3 = ok[:, None, None]
                p = torch.where(ok3, p_, p)
                ln = torch.where(ok, ln_, ln)
                U0 = torch.where(ok, U_, U0)
                lml = torch.where(ok, lml_, lml)
                g_p = torch.where(ok3, gp_, g_p)
                g_n = torch.where(ok, gn_, g_n)
                okf = ok.to(scale.dtype)
                scale = torch.clamp(
                    scale * torch.exp(_ADAPT_RATE * (okf - _TARGET_ACCEPT)),
                    *_SCALE_BOUNDS)
                n_acc = n_acc + okf
        rate = n_acc / max(n_steps, 1)
        return p, ln, lml, rate, scale, (U0, g_p, g_n)
