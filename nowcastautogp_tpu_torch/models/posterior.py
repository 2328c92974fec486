"""Predictive posterior: a particle-weighted mixture of multivariate normals.

Port of the JAX package's ``models/posterior.py``, numpy only and carried
over whole, so for the same inputs and numpy generator state its draws are
bitwise the JAX package's.  A mixture over weighted particles, sampleable
jointly (one component pick + one joint MVN draw per sample column).
Mean/cov arrive from the batched predictive (``predict_mvn``); the Cholesky
factors for sampling are computed once per distribution.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MvNormalMixture"]


class MvNormalMixture:
    """Mixture of P multivariate normals over m points.

    weights: (P,) normalized; means: (P, m); covs: (P, m, m).  Values are on
    the *transformed data* scale (the caller applies the inverse data
    transformation afterwards, as in the reference's ``forecast``).
    """

    def __init__(self, weights: np.ndarray, means: np.ndarray, covs: np.ndarray):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.means = np.asarray(means, dtype=np.float64)
        self.covs = np.asarray(covs, dtype=np.float64)
        self._chols: np.ndarray | None = None

    @property
    def n_points(self) -> int:
        return self.means.shape[1]

    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    def _cholesky(self) -> np.ndarray:
        if self._chols is None:
            covs = self.covs.copy()
            m = covs.shape[1]
            eye = np.eye(m)
            chols = np.empty_like(covs)
            for i in range(covs.shape[0]):
                c = 0.5 * (covs[i] + covs[i].T)
                jit = 1e-10 * max(1.0, np.abs(np.diag(c)).max())
                for _ in range(8):
                    try:
                        chols[i] = np.linalg.cholesky(c + jit * eye)
                        break
                    except np.linalg.LinAlgError:
                        jit *= 10.0
                else:  # pragma: no cover - pathological
                    # eigenvalue floor as a last resort
                    w, V = np.linalg.eigh(c)
                    chols[i] = np.linalg.cholesky(
                        (V * np.maximum(w, 1e-8)) @ V.T
                    )
            self._chols = chols
        return self._chols

    def mean(self) -> np.ndarray:
        return self.weights @ self.means

    def sample(self, rng: np.random.Generator, n_draws: int) -> np.ndarray:
        """Draw ``n_draws`` joint samples -> (m, n_draws) matrix."""
        chols = self._cholesky()
        comps = rng.choice(self.n_components, size=n_draws, p=self.weights)
        eps = rng.standard_normal((n_draws, self.n_points))
        out = np.empty((self.n_points, n_draws))
        for j, c in enumerate(comps):
            out[:, j] = self.means[c] + chols[c] @ eps[j]
        return out

    def marginal_quantiles(self, qs, n_draws: int = 4000,
                           rng: np.random.Generator | None = None) -> np.ndarray:
        """Per-point quantiles of the mixture, (len(qs), m)."""
        rng = rng or np.random.default_rng(0)
        draws = self.sample(rng, n_draws)
        return np.quantile(draws, np.asarray(qs), axis=1)
