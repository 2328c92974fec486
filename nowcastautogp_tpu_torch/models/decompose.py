"""Posterior kernel decomposition: per-particle additive component split.

Port of the JAX package's ``models/decompose.py``.  Each particle's kernel
expression tree is split at its root-level ``+`` nodes into maximal
non-additive components (a ``CP`` or ``×`` subtree stays atomic), and each
component's posterior GP is computed under the FULL model's conditioning
-- ``mean_c = K_c(xs, x) A^{-1} y`` and
``cov_c = K_c(xs, xs) − K_c(xs, x) A^{-1} K_c(x, xs)`` with
``A = K(x, x) + noise·I`` -- so the component means sum exactly to the full
(noise-free) predictive mean.

The JAX package computes this outside any Pallas kernel (its covariance
interpreter, a Cholesky, triangular solves) one particle at a time; here
the same steps run as torch ops on the model's device -- the covariance
interpreter ``eval_cov_batch`` and ``torch.linalg.cholesky_ex`` -- batched
over every particle, and over every (particle, component) pair for the
component covariances.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import eval_cov_batch
from ..ops.lml import DEFAULT_JITTER
from ..ops.megalml import cholesky_nan
from .gp_model import normalized_weights
from .structures import BINARY_TYPES, EMPTY, PLUS, structure_to_str

__all__ = ["decompose"]


def _component_roots(node_types: np.ndarray) -> list[int]:
    """Heap indices of the maximal non-PLUS subtrees (root-level addends)."""
    n = node_types.shape[0]
    roots, stack = [], [0]
    while stack:
        i = stack.pop()
        if i >= n or int(node_types[i]) == EMPTY:
            continue
        if int(node_types[i]) == PLUS:
            stack.extend((2 * i + 1, 2 * i + 2))
        else:
            roots.append(i)
    return sorted(roots)


def _extract_subtree(node_types: np.ndarray, params: np.ndarray, root: int):
    """Relocate the subtree at ``root`` to heap slot 0 (own fresh buffers).

    Moving a subtree toward the root only shrinks depths, so the extracted
    tree always fits the same heap capacity.
    """
    n = node_types.shape[0]
    t2 = np.zeros_like(node_types)
    p2 = np.zeros_like(params)
    stack = [(root, 0)]
    while stack:
        s, d = stack.pop()
        if s >= n or int(node_types[s]) == EMPTY:
            continue
        t2[d] = node_types[s]
        p2[d] = params[s]
        if int(node_types[s]) in BINARY_TYPES:
            stack.append((2 * s + 1, 2 * d + 1))
            stack.append((2 * s + 2, 2 * d + 2))
    return t2, p2


def decompose(model, ds) -> list[dict]:
    """Per-particle additive decomposition of the posterior at dates ``ds``.

    Returns one dict per particle::

        {"structure": str,          # the particle's full kernel expression
         "weight": float,           # normalized importance weight
         "components": [            # one entry per root-level addend
             {"structure": str,
              "mean": (m,) float64, # on the transformed-data scale, CENTERED:
                                    # full noise-free predictive mean =
                                    # model y-mean + sum of component means
              "var":  (m,) float64} # marginal posterior variance (no
                                    # observation noise)
         ]}

    A numerically broken particle (non-PSD covariance, the state the LML
    sites map to the -1e10 sentinel) gets ``"components": []`` plus
    ``"broken": True`` instead of silent NaN means.

    Values are on the transformed-data scale like ``predict_mvn``.
    """
    dev = model.device
    xs = model._tensor(model._normalize_dates(ds))
    x_b, y_b, m_b = model._batched_data()
    x, y, mask = x_b[0], y_b[0], m_b[0]
    types_all = np.asarray(model._host_types)
    params_all = model._params_d.detach().cpu().numpy()
    w = normalized_weights(model)
    y_std = float(model._y_std)
    P = types_all.shape[0]

    types_d = torch.as_tensor(types_all, device=dev)
    with torch.no_grad():
        # A = K(x, x) o (m m^T) + diag(mask (noise + jitter) + 1 - mask)
        K = eval_cov_batch(types_d, model._params_d, x, x)
        diag = (mask * (torch.exp(model._log_noise_d)[:, None]
                        + DEFAULT_JITTER) + (1.0 - mask))
        A = K * (mask[:, None] * mask[None, :]) + torch.diag_embed(diag)
        L = cholesky_nan(A)
        broken = ~torch.isfinite(L).all(-1).all(-1)
        alpha = torch.cholesky_solve((y * mask).expand(P, -1)[..., None],
                                     L)[..., 0]

        # every (particle, component) pair of the unbroken particles
        broken_np = broken.cpu().numpy()
        owners, t2s, p2s = [], [], []
        for p in np.flatnonzero(~broken_np):
            for r in _component_roots(types_all[p]):
                t2, p2 = _extract_subtree(types_all[p], params_all[p], r)
                owners.append(p)
                t2s.append(t2)
                p2s.append(p2)
        if owners:
            own = torch.as_tensor(np.asarray(owners), device=dev)
            t2_d = torch.as_tensor(np.stack(t2s), device=dev)
            p2_d = model._tensor(np.stack(p2s))
            Ks = eval_cov_batch(t2_d, p2_d, x, xs) * mask[:, None]  # (C, n, m)
            Kss = eval_cov_batch(t2_d, p2_d, xs, xs)
            mu_c = torch.einsum("cnm,cn->cm", Ks, alpha[own])
            V = torch.linalg.solve_triangular(L[own], Ks, upper=False)
            var_c = torch.clamp_min(
                torch.diagonal(Kss, dim1=-2, dim2=-1) - (V * V).sum(-2), 0.0)
            mu_c = mu_c.cpu().numpy().astype(np.float64)
            var_c = var_c.cpu().numpy().astype(np.float64)

    out = [{"structure": structure_to_str(types_all[p]),
            "weight": float(w[p]), "components": []} for p in range(P)]
    for p in np.flatnonzero(broken_np):
        # numerically broken particle (non-PSD covariance): the LML sites
        # map this state to the -1e10 sentinel; skip the component split
        # instead of emitting silent NaNs
        out[p]["broken"] = True
    for c, p in enumerate(owners):
        out[p]["components"].append({
            "structure": structure_to_str(t2s[c]),
            "mean": y_std * mu_c[c],
            "var": (y_std ** 2) * var_c[c],
        })
    return out
