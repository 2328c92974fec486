"""GP prior configuration.

Port of the JAX package's equivalent of AutoGP.jl's ``GP.GPConfig`` as exercised by the
reference (surface documented at ``src/make_and_fit_model.jl:44-48``
and ``docs/vignettes/setting-priors.jl:50-76``):

* ``node_dist_leaf`` — probability vector over the five primitive (leaf)
  kernels, indexed ``Constant=0, Linear=1, SquaredExponential=2,
  GammaExponential=3, Periodic=4`` (the reference documents the same order
  1-based).  The default gives zero mass to Constant and SquaredExponential.
* ``node_dist_nocp`` / ``node_dist_cp`` — probability vectors over the node
  role drawn at each internal position: ``(leaf, plus, times)`` without
  changepoints, ``(leaf, plus, times, changepoint)`` with.
* ``changepoints`` — whether ChangePoint internal nodes are allowed.
* ``prior`` — nested dict of hyperparameter priors over the *unconstrained*
  parameterization: ``prior["period"]`` is a Normal(mu, sigma) over the log
  period in normalized time (the time axis is rescaled to [0, 1], so the
  default median period is ~0.22 of the training window, matching the
  behavior documented at ``docs/vignettes/setting-priors.jl:71-76``);
  ``prior["gamma"]`` governs the GammaExponential exponent's unconstrained
  coordinate (``gamma = 2*sigmoid(raw)``); ``prior["wildcard"]`` covers all
  other unconstrained hyperparameters.
* ``noise`` — fixed observation-noise variance on the normalized scale, or
  ``None`` to infer it.
* ``max_depth`` — tree depth cap; ``-1`` selects the engine default
  (:data:`DEFAULT_DEPTH`, i.e. up to ``2**DEFAULT_DEPTH - 1`` heap slots).

Contract preserved from the reference: the config object is stored *by
reference* on the model and passed through untouched
(``test/test_gpconfig.jl:9`` asserts ``model.config === cfg``), so this class
deliberately uses identity equality.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Sequence

__all__ = ["GPConfig", "HMCConfig", "default_prior", "DEFAULT_DEPTH"]

# Default tree depth cap: complete binary heap of 2**5 - 1 = 31 node slots.
DEFAULT_DEPTH = 5


def default_prior() -> dict:
    """Default hyperparameter priors (unconstrained-space Normals)."""
    return {
        "gamma": {"mu": 0.0, "sigma": 1.0},
        # log-period over normalized time: median exp(-1.5) ~ 0.22 of the window
        "period": {"mu": -1.5, "sigma": 1.0},
        "wildcard": {"mu": 0.0, "sigma": 1.0},
    }


@dataclasses.dataclass(eq=False)
class GPConfig:
    """Structure-prior / engine configuration (the reference's ``GP.GPConfig``).

    ``max_depth``: tree depth cap in levels; ``-1`` (the default) resolves to
    ``DEFAULT_DEPTH`` (5, a 31-slot heap).  NOTE this differs from the
    reference, whose structure language composes without a depth bound
    (``docs/vignettes/setting-priors.jl:17-21``): the heap encoding needs a
    static shape, so depth is always capped here.  The statistical cost of
    the cap is measured in PLAN.md's "depth study" (depth 5 vs 6 on the
    bench workload); raise ``max_depth`` explicitly if your prior needs
    deeper composition.
    """

    node_dist_leaf: Sequence[float] = (0.0, 1.0 / 3, 0.0, 1.0 / 3, 1.0 / 3)
    node_dist_nocp: Sequence[float] = (0.6, 0.2, 0.2)
    node_dist_cp: Sequence[float] = (0.54, 0.18, 0.18, 0.1)
    changepoints: bool = True
    max_depth: int = -1
    noise: Optional[float] = None
    prior: dict = dataclasses.field(default_factory=default_prior)

    def __post_init__(self):
        for name in ("node_dist_leaf", "node_dist_nocp", "node_dist_cp"):
            p = [float(v) for v in getattr(self, name)]
            total = sum(p)
            if total <= 0:
                raise ValueError(f"{name} must have positive mass")
            if not math.isclose(total, 1.0, rel_tol=0, abs_tol=1e-6):
                p = [v / total for v in p]
            setattr(self, name, p)
        if len(self.node_dist_leaf) != 5:
            raise ValueError("node_dist_leaf must have 5 entries")
        if len(self.node_dist_nocp) != 3:
            raise ValueError("node_dist_nocp must have 3 entries (leaf, plus, times)")
        if len(self.node_dist_cp) != 4:
            raise ValueError(
                "node_dist_cp must have 4 entries (leaf, plus, times, changepoint)"
            )
        for key in ("gamma", "period", "wildcard"):
            if key not in self.prior:
                raise ValueError(f"prior must contain a {key!r} entry")

    @property
    def depth(self) -> int:
        """Effective tree depth (levels) after resolving ``max_depth=-1``."""
        return DEFAULT_DEPTH if self.max_depth < 0 else max(1, self.max_depth)

    @property
    def max_nodes(self) -> int:
        return 2**self.depth - 1

    def replace(self, **changes) -> "GPConfig":
        """Copy-and-update, the ``Accessors.@set`` ergonomic of the reference."""
        new = copy.copy(self)
        new.prior = copy.deepcopy(self.prior)
        for k, v in changes.items():
            setattr(new, k, v)
        new.__post_init__()
        return new


@dataclasses.dataclass(eq=False)
class HMCConfig:
    """HMC trajectory settings (the reference forwards an opaque ``hmc_config``
    to ``AutoGP.fit_smc!``; ``src/make_and_fit_model.jl:49-52``)."""

    n_leapfrog: int = 5
    step_size: float = 0.02
    # multiplicative jitter on the step size per trajectory, in [1-j, 1+j]
    step_size_jitter: float = 0.5
