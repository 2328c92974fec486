"""Particle resampling (systematic / multinomial / residual) and ESS.

Port of the JAX package's ``inference/resample.py``.  Index selection is
O(P) host work on a P-vector of weights and stays numpy, so for the same
generator state the indices equal the JAX package's; the state shuffle is a
torch index along the particle axis on the particles' device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ess", "resample_indices", "gather_particles"]


def ess(log_weights: np.ndarray) -> float:
    """Effective sample size of (unnormalized) log importance weights."""
    lw = np.asarray(log_weights, dtype=np.float64)
    lw = lw - lw.max()
    w = np.exp(lw)
    w /= w.sum()
    return float(1.0 / np.sum(w * w))


def resample_indices(
    rng: np.random.Generator, log_weights: np.ndarray, method: str = "systematic"
) -> np.ndarray:
    """Draw ancestor indices from normalized weights."""
    lw = np.asarray(log_weights, dtype=np.float64)
    lw = lw - lw.max()
    w = np.exp(lw)
    w /= w.sum()
    P = w.shape[0]
    if method == "multinomial":
        return rng.choice(P, size=P, p=w).astype(np.int32)
    if method == "residual":
        counts = np.floor(P * w).astype(np.int64)
        idx = np.repeat(np.arange(P), counts)
        n_rest = P - idx.shape[0]
        if n_rest > 0:
            resid = P * w - counts
            resid /= resid.sum()
            idx = np.concatenate([idx, rng.choice(P, size=n_rest, p=resid)])
        return idx.astype(np.int32)
    # systematic (default): stratified positions with a single uniform offset
    positions = (rng.uniform() + np.arange(P)) / P
    return np.searchsorted(np.cumsum(w), positions).clip(0, P - 1).astype(np.int32)


def gather_particles(state_arrays, indices):
    """Index every per-particle tensor of a tuple along axis 0."""
    return tuple(a[indices] for a in state_arrays)
