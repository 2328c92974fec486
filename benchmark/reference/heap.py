"""Covariances of heap-encoded kernel trees, frozen for the reference.

A copy of the level-vectorised interpreter the program's plain path uses:
children of slot ``i`` at ``2i+1`` and ``2i+2``, one batched tensor op per
heap level.  Node codes and semantics (unconstrained parameters):

* 1 Constant:   exp(p0)
* 2 Linear:     exp(p1) (x1 - p0)(x2 - p0)
* 3 SquaredExp: exp(p1) exp(-r^2 / (2 l^2)), l = exp(p0)
* 4 GammaExp:   exp(p2) exp(-(r / l)^g), l = exp(p0), g = 2 sigmoid(p1)
* 5 Periodic:   exp(p2) exp(-2 sin^2(pi r / T) / l^2), l = exp(p0),
                T = exp(p1)
* 6 Plus, 7 Times: sum and product of the children
* 8 ChangePoint: s(x1) s(x2) k_left + (1 - s(x1)) (1 - s(x2)) k_right,
                 s(x) = sigmoid((x - p0) / exp(p1))
"""

from __future__ import annotations

import math

import torch

CONST, LINEAR, SE, GE, PERIODIC, PLUS, TIMES, CP = range(1, 9)
_LOG_EPS = -27.631021  # log(1e-12): the GammaExp r / l clamp in log space


def _leaf_values(t, p, x1, x2, r, r2, log_r):
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

    cx1 = x1[:, None, :] - p[:, :, 0, None]
    cx2 = x2[:, None, :] - p[:, :, 0, None]
    k_lin = torch.exp(p1) * (cx1[..., :, None] * cx2[..., None, :])

    is_exp_leaf = ((tcol == CONST) | (tcol == SE) | (tcol == GE)
                   | (tcol == PERIODIC))
    out = torch.where(is_exp_leaf, k_exp, zero)
    return torch.where(tcol == LINEAR, k_lin, out)


def cov(node_types, params, x1, x2):
    """K(x1, x2) of P trees -> (P, n, m).  ``node_types`` (P, N) integer,
    ``params`` (P, N, 3); ``x1`` (P, n) or (n,), ``x2`` (P, m) or (m,)."""
    P, max_nodes = node_types.shape
    levels = int(math.log2(max_nodes + 1))
    x1 = x1.expand(P, x1.shape[-1])
    x2 = x2.expand(P, x2.shape[-1])
    d = x1[:, :, None] - x2[:, None, :]
    r = torch.abs(d)
    r2 = d * d
    log_r = torch.log(torch.clamp_min(r, 1e-30))

    below = None
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
            inv_scale = torch.exp(-p[:, :, 1, None])
            s1 = torch.sigmoid((x1[:, None, :] - p[:, :, 0, None]) * inv_scale)
            s2 = torch.sigmoid((x2[:, None, :] - p[:, :, 0, None]) * inv_scale)
            k_cp = (s1[..., :, None] * s2[..., None, :] * left
                    + (1.0 - s1)[..., :, None] * (1.0 - s2)[..., None, :]
                    * right)
            cur = torch.where(tcol == CP, k_cp, cur)
        below = cur
    return below[:, 0]
