"""Masked log marginal likelihood and GP predictive posterior, batched.

Port of the JAX package's ``ops/lml.py``.  Every op takes a fixed-capacity
``(P, n_cap)`` data buffer plus a {0,1} ``mask``: masked rows and columns of
the covariance become identity rows, so the Cholesky factor carries exact
zeros and ones there and the log-determinant and quadratic form reduce to
the active subset.  A particle whose LML is not finite gets ``-1e10``, so
SMC weights and MH accepts treat a numerically broken proposal as
rejected.

The LML core goes through ``ops/megalml.py``: on a CUDA tensor the fused
CUDA kernels, on a CPU tensor their plain version.  Both sides of every
comparison the fit makes (MH logits, reweight deltas, values carried out of
HMC) therefore come from one numerical core at a given device.
"""

from __future__ import annotations

import torch

from .kernels import eval_cov_batch
from .megalml import cholesky_nan, lml_core

__all__ = [
    "masked_kernel_matrix", "gp_lml_batched", "gp_predict_batch",
    "sampling_cholesky", "LOG_2PI", "DEFAULT_JITTER",
]

LOG_2PI = 1.8378770664093453
DEFAULT_JITTER = 1e-5


def masked_kernel_matrix(node_types, params, log_noise, x, mask,
                         jitter=DEFAULT_JITTER):
    """K(x,x) + (noise+jitter)·I on active rows, identity on masked rows.

    Batched: node_types (P, N), params (P, N, 3), log_noise (P,), x and mask
    (P, n) or a shared (n,).  Returns (P, n, n).
    """
    K = eval_cov_batch(node_types, params, x, x)
    mm = mask[..., :, None] * mask[..., None, :]
    diag = mask * (torch.exp(log_noise)[:, None] + jitter) + (1.0 - mask)
    return K * mm + torch.diag_embed(diag)


def gp_lml_batched(node_types, params, log_noise, x, y, mask,
                   jitter=DEFAULT_JITTER):
    """Masked LML of P particles -> (P,), with the ``-1e10`` guard.

    The diagonal augmentation and ``y * mask`` are built here, so their
    chain rules (d diag / d log_noise = mask·noise, d ym / d y = mask) compose
    with the core's gradients for ``diagv`` and ``ym``.
    """
    P, n = params.shape[0], x.shape[-1]
    mask = mask.expand(P, n)
    diagv = mask * (torch.exp(log_noise)[:, None] + jitter) + (1.0 - mask)
    ym = y.expand(P, n) * mask
    core = lml_core(node_types, params, diagv, mask, x.expand(P, n), ym)
    lml = core - 0.5 * mask.sum(-1) * LOG_2PI
    return torch.where(torch.isfinite(lml), lml, torch.full_like(lml, -1e10))


def gp_predict_batch(node_types, params, log_noise, x, y, mask, xs,
                     jitter=DEFAULT_JITTER, include_noise=True):
    """Predictive posterior N(mu, cov) of P particles at test points ``xs``.

    The predictive is over *observations*: the observation-noise variance is
    added to the covariance diagonal when ``include_noise``.  Returns
    mu (P, m) and cov (P, m, m).
    """
    P = params.shape[0]
    A = masked_kernel_matrix(node_types, params, log_noise, x, mask, jitter)
    L = cholesky_nan(A)
    mask = mask.expand(P, A.shape[-1])
    ym = (y.expand(P, A.shape[-1]) * mask)[..., None]
    alpha = torch.cholesky_solve(ym, L)                          # (P, n, 1)
    Ks = eval_cov_batch(node_types, params, x, xs) * mask[..., :, None]
    Kss = eval_cov_batch(node_types, params, xs, xs)
    mu = (Ks.transpose(-1, -2) @ alpha)[..., 0]
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    cov = Kss - V.transpose(-1, -2) @ V
    extra = (torch.exp(log_noise) if include_noise
             else torch.zeros_like(log_noise)) + jitter
    eye = torch.eye(xs.shape[-1], dtype=cov.dtype, device=cov.device)
    return mu, cov + extra[:, None, None] * eye


def sampling_cholesky(cov):
    """Guaranteed-PSD sampling factor for (..., m, m) predictive covariances.

    Large-amplitude particles can make ``Kss - V^T V`` indefinite in f32;
    negative eigenvalues are clamped and ``A = V sqrt(w)`` is returned (any
    square root samples the same Gaussian).
    """
    c = 0.5 * (cov + cov.transpose(-1, -2))
    w, V = torch.linalg.eigh(c)
    scale = torch.clamp_min(w.abs().amax(-1, keepdim=True), 1.0)
    w = torch.maximum(w, 1e-8 * scale)
    return V * torch.sqrt(w)[..., None, :]
