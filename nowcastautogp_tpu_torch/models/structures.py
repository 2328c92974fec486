"""Kernel expression trees: host-side representation, priors, and proposals.

The engine's central design (SURVEY.md §7): every particle carries a
*compositional kernel expression tree* — leaves from {Constant, Linear,
SquaredExponential, GammaExponential, Periodic}, internal nodes from
{Plus, Times, ChangePoint} (matching the structure language documented at
``docs/vignettes/setting-priors.jl:17-21,50-62``).  To keep tensor
shapes static while structures churn under MCMC, trees are encoded as a
fixed-size *complete binary heap*:

* ``node_types``: int32[max_nodes], heap-indexed (children of ``i`` at
  ``2i+1``/``2i+2``), with 0 = empty slot.
* ``params``: float32[max_nodes, 3] of *unconstrained* hyperparameters; the
  meaning of each slot depends on the node type (see ``ops/kernels.py``).

Structure *proposals* (subtree-regeneration involutive moves) and prior
sampling are irregular, so they run host-side in numpy; likelihood evaluation
of proposals is a batched device call (see ``inference/structure_mcmc.py``).
With subtrees regenerated from the prior at a uniformly chosen node, the MH
acceptance ratio reduces to ``LML' - LML + log|T| - log|T'|`` (structure-prior
and parameter-prior factors cancel against the proposal density).
"""

from __future__ import annotations

import numpy as np

from .config import GPConfig

__all__ = [
    "EMPTY", "CONST", "LINEAR", "SE", "GE", "PERIODIC", "PLUS", "TIMES", "CP",
    "N_PARAM_SLOTS", "LEAF_TYPES", "BINARY_TYPES",
    "sample_structure", "sample_params_for_subtree", "sample_particle",
    "log_prior_structure", "count_nodes", "param_slot_kinds", "prior_arrays",
    "subtree_slots", "propose_subtree_replace", "propose_leaf_swap",
    "propose_birth_death", "log_prior_params",
    "structure_to_str",
]

# Node type codes. Leaf codes 1..5 match the reference's documented leaf
# indexing (Constant=1, Linear=2, SquaredExponential=3, GammaExponential=4,
# Periodic=5; docs/vignettes/setting-priors.jl:50-62).
EMPTY, CONST, LINEAR, SE, GE, PERIODIC, PLUS, TIMES, CP = range(9)

LEAF_TYPES = (CONST, LINEAR, SE, GE, PERIODIC)
BINARY_TYPES = (PLUS, TIMES, CP)
N_PARAM_SLOTS = 3

# Per node type: the prior "kind" of each unconstrained parameter slot.
# None = inactive slot; "wildcard"/"period"/"gamma" select prior entries.
_SLOT_KINDS = {
    EMPTY: (None, None, None),
    CONST: ("wildcard", None, None),           # log amplitude^2
    LINEAR: ("wildcard", "wildcard", None),    # intercept, log amplitude^2
    SE: ("wildcard", "wildcard", None),        # log lengthscale, log amplitude^2
    GE: ("wildcard", "gamma", "wildcard"),     # log lengthscale, gamma raw, log amp^2
    PERIODIC: ("wildcard", "period", "wildcard"),  # log lengthscale, log period, log amp^2
    PLUS: (None, None, None),
    TIMES: (None, None, None),
    CP: ("wildcard", "wildcard", None),        # location, log scale
}

_NAMES = ["∅", "Const", "Linear", "SE", "GammaExp", "Periodic", "+", "×", "CP"]


def _depth_of(i: int) -> int:
    return int(np.log2(i + 1))


def _levels(max_nodes: int) -> int:
    return int(np.log2(max_nodes + 1))


def param_slot_kinds(node_type: int):
    return _SLOT_KINDS[int(node_type)]


def _sample_leaf(rng: np.random.Generator, config: GPConfig) -> int:
    return LEAF_TYPES[rng.choice(5, p=np.asarray(config.node_dist_leaf))]


def _node_dist(config: GPConfig) -> np.ndarray:
    return np.asarray(config.node_dist_cp if config.changepoints else config.node_dist_nocp)


def sample_structure(
    rng: np.random.Generator, config: GPConfig, max_nodes: int | None = None,
    root: int = 0, out: np.ndarray | None = None,
) -> np.ndarray:
    """Sample a tree (or subtree rooted at ``root``) from the PCFG prior."""
    max_nodes = config.max_nodes if max_nodes is None else max_nodes
    levels = _levels(max_nodes)
    if out is None:
        out = np.zeros(max_nodes, dtype=np.int32)

    def fill(i: int):
        if _depth_of(i) == levels - 1:
            out[i] = _sample_leaf(rng, config)
            return
        dist = _node_dist(config)
        choice = rng.choice(len(dist), p=dist)
        if choice == 0:
            out[i] = _sample_leaf(rng, config)
        else:
            out[i] = (PLUS, TIMES, CP)[choice - 1]
            fill(2 * i + 1)
            fill(2 * i + 2)

    fill(root)
    return out


def log_prior_structure(node_types: np.ndarray, config: GPConfig, root: int = 0) -> float:
    """Log prior probability of the (sub)tree under the PCFG."""
    levels = _levels(node_types.shape[0])
    leaf_p = np.asarray(config.node_dist_leaf)
    dist = _node_dist(config)

    def walk(i: int) -> float:
        t = int(node_types[i])
        at_max = _depth_of(i) == levels - 1
        if t in LEAF_TYPES:
            lp = np.log(leaf_p[t - CONST]) if leaf_p[t - CONST] > 0 else -np.inf
            if not at_max:
                lp += np.log(dist[0]) if dist[0] > 0 else -np.inf
            return float(lp)
        idx = 1 + BINARY_TYPES.index(t)
        lp = np.log(dist[idx]) if dist[idx] > 0 else -np.inf
        return float(lp) + walk(2 * i + 1) + walk(2 * i + 2)

    return walk(root)


def count_nodes(node_types: np.ndarray) -> int:
    return int(np.sum(node_types != EMPTY))


def subtree_slots(node_types: np.ndarray, root: int) -> list[int]:
    """Heap indices of the subtree rooted at ``root`` (occupied slots only)."""
    n = node_types.shape[0]
    slots, stack = [], [root]
    while stack:
        i = stack.pop()
        if i >= n or node_types[i] == EMPTY:
            continue
        slots.append(i)
        if node_types[i] in BINARY_TYPES:
            stack.extend((2 * i + 1, 2 * i + 2))
    return slots


def sample_params_for_subtree(
    rng: np.random.Generator, node_types: np.ndarray, config: GPConfig,
    slots: list[int], params: np.ndarray | None = None,
) -> np.ndarray:
    """Sample unconstrained params from the prior for the given node slots."""
    if params is None:
        params = np.zeros((node_types.shape[0], N_PARAM_SLOTS), dtype=np.float32)
    for i in slots:
        kinds = _SLOT_KINDS[int(node_types[i])]
        for s, kind in enumerate(kinds):
            if kind is None:
                params[i, s] = 0.0
            else:
                pr = config.prior[kind]
                params[i, s] = rng.normal(pr["mu"], pr["sigma"])
    return params


def sample_particle(rng: np.random.Generator, config: GPConfig):
    """Sample a full particle (structure, params, log-noise) from the prior."""
    types = sample_structure(rng, config)
    params = sample_params_for_subtree(rng, types, config, subtree_slots(types, 0))
    wc = config.prior["wildcard"]
    if config.noise is None:
        # log observation-noise variance; offset low — data is standardized
        log_noise = rng.normal(wc["mu"] - 2.0, wc["sigma"])
    else:
        log_noise = np.log(float(config.noise))
    return types, params, np.float32(log_noise)


def prior_arrays(node_types_batch: np.ndarray, config: GPConfig):
    """Per-slot prior (mu, sigma, active) arrays for a batch of trees.

    ``node_types_batch``: int32[P, max_nodes].  Returns float32 arrays of shape
    [P, max_nodes, 3] used by the device-side HMC log-posterior; recomputed
    host-side after every accepted structure move (host owns the trees).
    """
    P, n = node_types_batch.shape
    mu = np.zeros((P, n, N_PARAM_SLOTS), dtype=np.float32)
    sigma = np.ones((P, n, N_PARAM_SLOTS), dtype=np.float32)
    active = np.zeros((P, n, N_PARAM_SLOTS), dtype=np.float32)
    # vectorized over the small set of node types
    for t, kinds in _SLOT_KINDS.items():
        sel = node_types_batch == t
        if not sel.any():
            continue
        for s, kind in enumerate(kinds):
            if kind is None:
                continue
            pr = config.prior[kind]
            mu[sel, s] = pr["mu"]
            sigma[sel, s] = pr["sigma"]
            active[sel, s] = 1.0
    return mu, sigma, active


def propose_subtree_replace(
    rng: np.random.Generator, node_types: np.ndarray, params: np.ndarray,
    config: GPConfig,
):
    """One involutive subtree-regeneration proposal for a single particle.

    Returns ``(new_types, new_params, log_hastings)`` where ``log_hastings`` is
    the proposal-asymmetry correction ``log|T| - log|T'|``; the caller adds the
    LML difference to form the MH acceptance logit.
    """
    occupied = np.flatnonzero(node_types != EMPTY)
    v = int(rng.choice(occupied))
    new_types = node_types.copy()
    new_params = params.copy()
    # clear old subtree
    for i in subtree_slots(node_types, v):
        new_types[i] = EMPTY
        new_params[i] = 0.0
    sample_structure(rng, config, max_nodes=node_types.shape[0], root=v, out=new_types)
    sample_params_for_subtree(
        rng, new_types, config, subtree_slots(new_types, v), new_params
    )
    log_hastings = float(np.log(count_nodes(node_types)) - np.log(count_nodes(new_types)))
    return new_types, new_params, log_hastings


def propose_leaf_swap(
    rng: np.random.Generator, node_types: np.ndarray, params: np.ndarray,
    config: GPConfig,
):
    """Leaf-type swap: resample one leaf's kernel type + params from the prior.

    Second involutive move alongside subtree regeneration (the engine's
    ``mcmc_structure!`` mixes several move types; regenerate-only samplers
    mix slowly on deep trees).  The proposal picks a leaf uniformly,
    redraws its type from ``node_dist_leaf`` and its params from their
    priors; because type and params are proposed exactly from their prior
    conditionals and the reverse move is symmetric, every prior/proposal
    term cancels and the Hastings correction is 0 (acceptance = LML ratio).
    """
    leaves = np.flatnonzero(np.isin(node_types, LEAF_TYPES))
    v = int(rng.choice(leaves))
    new_types = node_types.copy()
    new_params = params.copy()
    new_types[v] = _sample_leaf(rng, config)
    new_params[v] = 0.0
    sample_params_for_subtree(rng, new_types, config, [v], new_params)
    return new_types, new_params, 0.0


def log_prior_params(
    node_types: np.ndarray, params: np.ndarray, config: GPConfig,
    slots,
) -> float:
    """Log prior density of the unconstrained params on the given slots."""
    lp = 0.0
    for i in slots:
        kinds = _SLOT_KINDS[int(node_types[i])]
        for s, kind in enumerate(kinds):
            if kind is None:
                continue
            pr = config.prior[kind]
            z = (float(params[i, s]) - pr["mu"]) / pr["sigma"]
            lp += -0.5 * z * z - np.log(pr["sigma"]) - 0.5 * np.log(2 * np.pi)
    return float(lp)


def _binary_dist(config: GPConfig) -> np.ndarray:
    """Proposal distribution over internal ops: the renormalized binary part
    of the PCFG node distribution (zero CP mass when changepoints=False)."""
    dist = _node_dist(config)
    b = np.asarray(dist[1:], dtype=np.float64)
    return b / b.sum()


def _birth_feasible(node_types: np.ndarray) -> list[int]:
    """Occupied slots whose subtree can be pushed one level deeper (no
    occupied node on the bottom heap level)."""
    levels = _levels(node_types.shape[0])
    return [
        int(v) for v in np.flatnonzero(node_types != EMPTY)
        if all(_depth_of(j) < levels - 1 for j in subtree_slots(node_types, v))
    ]


def _down_index_map(slots: list[int], v: int, target_v: int) -> dict[int, int]:
    """Heap-index map relocating the subtree at ``v`` so its root lands at
    ``target_v`` (one level down for birth, one level up for death): children
    follow their parent's new position."""
    new_idx = {v: target_v}
    for j in sorted(slots):
        if j == v:
            continue
        parent = (j - 1) // 2
        new_idx[j] = 2 * new_idx[parent] + 1 + (j - 2 * parent - 1)
    return new_idx


def propose_birth_death(
    rng: np.random.Generator, node_types: np.ndarray, params: np.ndarray,
    config: GPConfig,
):
    """Reversible birth/death dimension move (third involutive move type).

    *Birth*: pick a feasible node ``v`` (its subtree must clear the bottom
    heap level), insert a new internal op above it — the old subtree is
    relocated intact (parameters preserved) to one side, the other side is a
    fresh prior-sampled subtree.  *Death*: pick an internal node, promote one
    child's subtree into its place and delete the other.  The pair is one MH
    kernel (50/50 birth-vs-death coin); an infeasible submove returns the
    state unchanged with ``log_hastings = -inf`` (forced reject).

    Unlike subtree regeneration, birth *preserves the learned parameters* of
    the existing kernel while growing structure around it — the move class
    that makes "wrap the current kernel in ``+ new``" reachable without
    re-discovering the kernel from the prior (the engine's ``mcmc_structure!``
    mixes several involutive move types; SURVEY.md §2.3).

    The Hastings correction is accounted numerically — full structure +
    parameter prior log-densities of both trees plus the exact proposal
    densities — rather than relying on symbolic cancellation, because the
    PCFG's bottom-level leaf forcing makes relocated-subtree prior terms
    depth-dependent.

    Returns ``(new_types, new_params, log_hastings)``.
    """
    n = node_types.shape[0]
    b_dist = _binary_dist(config)
    reject = (node_types, params, float(-np.inf))

    def _lp_full(t, p):
        return log_prior_structure(t, config) + log_prior_params(
            t, p, config, subtree_slots(t, 0))

    if rng.random() < 0.5:  # ---- birth
        feas = _birth_feasible(node_types)
        if not feas:
            return reject
        v = int(rng.choice(feas))
        oi = int(rng.choice(3, p=b_dist))
        o = BINARY_TYPES[oi]
        side = int(rng.integers(2))
        slots = subtree_slots(node_types, v)
        new_types = node_types.copy()
        new_params = params.copy()
        for j in slots:
            new_types[j] = EMPTY
            new_params[j] = 0.0
        new_idx = _down_index_map(slots, v, 2 * v + 1 + side)
        for j in slots:
            new_types[new_idx[j]] = node_types[j]
            new_params[new_idx[j]] = params[j]
        new_types[v] = o
        sample_params_for_subtree(rng, new_types, config, [v], new_params)
        sib = 2 * v + 1 + (1 - side)
        sample_structure(rng, config, max_nodes=n, root=sib, out=new_types)
        sample_params_for_subtree(
            rng, new_types, config, subtree_slots(new_types, sib), new_params)

        n_internal2 = sum(
            1 for j in subtree_slots(new_types, 0)
            if new_types[j] in BINARY_TYPES)
        log_q_fwd = (
            -np.log(len(feas)) + np.log(b_dist[oi]) - np.log(2.0)
            + log_prior_structure(new_types, config, root=sib)
            + log_prior_params(
                new_types, new_params, config, subtree_slots(new_types, sib))
            + log_prior_params(new_types, new_params, config, [v])
        )
        log_q_rev = -np.log(n_internal2) - np.log(2.0)
        log_h = (_lp_full(new_types, new_params) - _lp_full(node_types, params)
                 + log_q_rev - log_q_fwd)
        return new_types, new_params, float(log_h)

    # ---- death
    internal = [
        int(u) for u in np.flatnonzero(node_types != EMPTY)
        if node_types[u] in BINARY_TYPES
    ]
    if not internal:
        return reject
    u = int(rng.choice(internal))
    c = int(rng.integers(2))
    child, other = 2 * u + 1 + c, 2 * u + 2 - c
    promoted = subtree_slots(node_types, child)
    deleted = subtree_slots(node_types, other)
    old_oi = BINARY_TYPES.index(int(node_types[u]))
    new_types = node_types.copy()
    new_params = params.copy()
    for j in subtree_slots(node_types, u):
        new_types[j] = EMPTY
        new_params[j] = 0.0
    new_idx = _down_index_map(promoted, child, u)
    for j in promoted:
        new_types[new_idx[j]] = node_types[j]
        new_params[new_idx[j]] = params[j]

    feas2 = _birth_feasible(new_types)
    log_q_fwd = -np.log(len(internal)) - np.log(2.0)
    log_q_rev = (
        -np.log(len(feas2)) + np.log(b_dist[old_oi]) - np.log(2.0)
        + log_prior_structure(node_types, config, root=other)
        + log_prior_params(node_types, params, config, deleted)
        + log_prior_params(node_types, params, config, [u])
    )
    log_h = (_lp_full(new_types, new_params) - _lp_full(node_types, params)
             + log_q_rev - log_q_fwd)
    return new_types, new_params, float(log_h)


def structure_to_str(node_types: np.ndarray, root: int = 0) -> str:
    """Human-readable rendering of a tree, e.g. ``(Linear + (Periodic × GammaExp))``."""
    t = int(node_types[root])
    if t == EMPTY:
        return "∅"
    if t in LEAF_TYPES:
        return _NAMES[t]
    left = structure_to_str(node_types, 2 * root + 1)
    right = structure_to_str(node_types, 2 * root + 2)
    if t == CP:
        return f"CP({left}; {right})"
    return f"({left} {_NAMES[t]} {right})"
