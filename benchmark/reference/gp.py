"""GP log marginal likelihood and predictive marginals in float64.

Rows are particles (or scenario x particle rows): each row has its tree,
parameters and log noise, every row shares the time axis ``x`` (n,), and
the targets ``Y`` are per row (R, n, S) or shared (n, S): S right-hand
sides.  A = K(x, x) + (exp(log_noise) + jitter) I; a row whose A is not
positive definite reads NaN.  Rows run in blocks sized so that a level's
(block, nodes, n, n) float64 planes stay near ``budget`` bytes.
"""

from __future__ import annotations

import math

import torch

from . import heap

LOG_2PI = math.log(2.0 * math.pi)
JITTER = 1e-5  # the model's diagonal jitter, part of its definition
U32 = 2.0**-24  # float32's unit roundoff


def round_tf32(K):
    """K rounded to TF32 (10 mantissa bits, to nearest even), as float64."""
    b = K.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32).to(torch.float64)


def _block(R, n, m, nodes, budget):
    side = max(n, m)
    return max(1, min(R, int(budget // (nodes * side * side * 8))))


def solve(types, params, log_noise, x, Y, xs=None, *, jitter=JITTER,
          k_round=None, sens=False, budget=1e9):
    """Per row: LML of each right-hand side (R, S) and, with ``xs`` (m,),
    the predictive means (R, S, m) and marginal variances (R, m), the
    observation noise included.  ``k_round`` maps K(x, x) before the
    factorisation (the control's lower precision).  ``sens`` (one
    right-hand side) adds each row's float32 sensitivity (R,): the first
    order bound on how far its LML moves when every entry of A and y and
    the LML itself carry one float32 rounding,
    u (|G| : |A| / 2 + |alpha| . |y| + |LML|), G = alpha alpha^T - A^-1,
    the LML's derivative in A times two."""
    dev = params.device
    R = params.shape[0]
    n = x.shape[-1]
    m = 0 if xs is None else xs.shape[-1]
    nodes = (types.shape[1] + 1) // 2
    B = _block(R, n, m, nodes, budget)
    lml, mus, vars_, sensitivity = [], [], [], []
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    for lo in range(0, R, B):
        t = types[lo:lo + B]
        p = params[lo:lo + B]
        noise = torch.exp(log_noise[lo:lo + B])
        Yb = Y[lo:lo + B] if Y.dim() == 3 else Y.expand(t.shape[0], *Y.shape)
        K = heap.cov(t, p, x, x)
        if k_round is not None:
            K = k_round(K)
        A = K + (noise + jitter)[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(A)
        bad = info != 0
        L = torch.where(bad[:, None, None], eye, L)
        alpha = torch.cholesky_solve(Yb, L)
        quad = (Yb * alpha).sum(-2)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        v = -0.5 * (quad + logdet[:, None] + n * LOG_2PI)
        lml.append(torch.where(bad[:, None], torch.nan, v))
        if sens:
            a = alpha[..., 0]
            G = a[:, :, None] * a[:, None, :] - torch.cholesky_inverse(L)
            sensitivity.append(U32 * (0.5 * (G.abs() * A.abs()).sum((1, 2))
                                      + (a * Yb[..., 0]).abs().sum(1)
                                      + v[:, 0].abs()))
        if xs is not None:
            Ks = heap.cov(t, p, x, xs)
            kss = torch.diagonal(heap.cov(t, p, xs, xs), dim1=-2, dim2=-1)
            mus.append((Ks.transpose(-1, -2) @ alpha).transpose(-1, -2))
            V = torch.linalg.solve_triangular(L, Ks, upper=False)
            vars_.append(kss - (V * V).sum(-2) + (noise + jitter)[:, None])
    out = {"lml": torch.cat(lml)}
    if sens:
        out["sens"] = torch.cat(sensitivity)
    if xs is not None:
        out["mu"] = torch.cat(mus)
        out["var"] = torch.cat(vars_)
    return out


def mixture_cdf(z, log_w, mu, sd):
    """CDF of a weighted Gaussian mixture at draws, per scenario and
    horizon: z (S, D, m), log_w (S, R), mu (S, R, m), sd (S, R, m) ->
    (S, D, m)."""
    w = torch.softmax(log_w, -1)
    out = []
    for s in range(z.shape[0]):
        u = torch.special.ndtr((z[s][:, None, :] - mu[s][None]) / sd[s][None])
        out.append((w[s][None, :, None] * u).sum(1))
    return torch.stack(out)
