"""Covariance assembly from heap-encoded kernel expression trees, in torch.

The level-vectorised interpreter of the JAX package's ``ops/kernels.py``
(``_leaf_values`` and ``eval_cov_impl``), written with an explicit particle
axis: the heap is processed one level at a time, every leaf value of a level
is one batched tensor op over the level's node axis, and internal nodes
combine the level below by type selects.  Autograd differentiates it, so it
is the plain covariance of the port: the reference every covariance kernel
is held against, and what ``ops/cov.py::cov_fn`` (the covariance backend)
computes wherever no kernel takes the shape.

Kernel semantics (unconstrained params; x is the time axis normalised to the
training window):

* Constant:        k = exp(p0)
* Linear:          k = exp(p1) · (x1 - c)(x2 - c),        c = p0
* SquaredExp:      k = exp(p1) · exp(-r² / (2ℓ²)),        ℓ = exp(p0)
* GammaExp:        k = exp(p2) · exp(-(r/ℓ)^γ),           ℓ = exp(p0), γ = 2σ(p1)
* Periodic:        k = exp(p2) · exp(-2 sin²(π r / T)/ℓ²), ℓ = exp(p0), T = exp(p1)
* Plus / Times:    k = k_left ± k_right (elementwise sum / product)
* ChangePoint:     k = s(x1)s(x2)·k_left + (1-s(x1))(1-s(x2))·k_right,
                   s(x) = sigmoid((x - loc)/scale), loc = p0, scale = exp(p1)
"""

from __future__ import annotations

import math

import torch

from ..models.structures import CONST, CP, GE, LINEAR, PERIODIC, PLUS, SE, TIMES

__all__ = ["eval_cov_batch"]

_LOG_EPS = -27.631021  # log(1e-12), the GammaExp r/ℓ clamp in log space


def _leaf_values(t, p, x1, x2, r, r2, log_r):
    """Leaf-kernel values of one heap level: t (P, k), p (P, k, 3) ->
    (P, k, n, m).  Every exp-family leaf selects its exp *argument* before
    one final ``exp``, as the JAX interpreter does."""
    tcol = t[:, :, None, None]
    p0 = p[:, :, 0, None, None]
    p1 = p[:, :, 1, None, None]
    p2 = p[:, :, 2, None, None]
    r_, r2_, log_r_ = r[:, None], r2[:, None], log_r[:, None]

    gamma = 2.0 * torch.sigmoid(p1)
    pow_term = torch.exp(gamma * torch.clamp_min(log_r_ - p0, _LOG_EPS))
    s = torch.sin(math.pi * r_ * torch.exp(-p1))

    zero = torch.zeros_like(pow_term)
    arg = torch.where(tcol == CONST, p0 + zero, zero)
    arg = torch.where(tcol == SE, p1 - 0.5 * r2_ * torch.exp(-2.0 * p0), arg)
    arg = torch.where(tcol == GE, torch.where(r_ > 0, p2 - pow_term, p2), arg)
    arg = torch.where(tcol == PERIODIC,
                      p2 - 2.0 * s * s * torch.exp(-2.0 * p0), arg)
    k_exp = torch.exp(arg)

    # Linear is not exp-family: a scalar exp outside the select
    cx1 = x1[:, None, :] - p[:, :, 0, None]          # (P, k, n)
    cx2 = x2[:, None, :] - p[:, :, 0, None]          # (P, k, m)
    k_lin = torch.exp(p1) * (cx1[..., :, None] * cx2[..., None, :])

    is_exp_leaf = ((tcol == CONST) | (tcol == SE) | (tcol == GE)
                   | (tcol == PERIODIC))
    out = torch.where(is_exp_leaf, k_exp, zero)
    return torch.where(tcol == LINEAR, k_lin, out)


def eval_cov_batch(node_types, params, x1, x2):
    """Covariances K(x1, x2) of P trees -> (P, n, m).

    node_types: int (P, N) heap encoding (children of ``i`` at
    ``2i+1``/``2i+2``); params: float (P, N, 3) unconstrained; x1: (P, n)
    or (n,); x2: (P, m) or (m,) — a 1-D axis is shared by every particle.
    """
    P, max_nodes = node_types.shape
    levels = int(math.log2(max_nodes + 1))
    x1 = x1.expand(P, x1.shape[-1])
    x2 = x2.expand(P, x2.shape[-1])
    d = x1[:, :, None] - x2[:, None, :]
    r = torch.abs(d)
    r2 = d * d
    # shared across every level and node: the GammaExp power's log-r plane
    log_r = torch.log(torch.clamp_min(r, 1e-30))

    below = None  # (P, 2**lev, n, m) values of the level just processed
    for lev in range(levels - 1, -1, -1):
        lo, hi = 2**lev - 1, 2 ** (lev + 1) - 1
        t = node_types[:, lo:hi]
        p = params[:, lo:hi]
        cur = _leaf_values(t, p, x1, x2, r, r2, log_r)
        if below is not None:
            left = below[:, 0::2]
            right = below[:, 1::2]
            tcol = t[:, :, None, None]
            cur = torch.where(tcol == PLUS, left + right, cur)
            cur = torch.where(tcol == TIMES, left * right, cur)
            inv_scale = torch.exp(-p[:, :, 1, None])            # (P, k, 1)
            s1 = torch.sigmoid((x1[:, None, :] - p[:, :, 0, None]) * inv_scale)
            s2 = torch.sigmoid((x2[:, None, :] - p[:, :, 0, None]) * inv_scale)
            k_cp = (s1[..., :, None] * s2[..., None, :] * left
                    + (1.0 - s1)[..., :, None] * (1.0 - s2)[..., None, :]
                    * right)
            cur = torch.where(tcol == CP, k_cp, cur)
        below = cur
    return below[:, 0]
