"""Device-side kernel-tree operations: prior arrays and subtree proposals.

Port of the JAX package's ``models/structures_device.py``.  The host
proposal path (``structures.py`` + ``inference/structure_mcmc.py``) builds
every proposal in numpy and copies the trees to the device once per move.
The heap encoding makes the whole proposal computable on the device
instead: every slot's ancestor chain is static, so "clear the subtree at v
and regenerate it from the PCFG prior" becomes a fixed sequence of per-slot
categorical draws and selects.

Where the JAX package writes one particle and ``vmap``s it, every function
here takes the particle axis directly: trees ``types`` (P, N) int32,
``params`` (P, N, 3) float32.  Regeneration runs level by level of the heap
(a slot's parent is one level up, so a level's slots are independent given
the level above), which is the JAX package's slot-by-slot loop with the
slots of a level taken at once.  Randomness comes from the caller's
``torch.Generator`` on the trees' device; every particle draws the same
number of variates, so nothing waits for the host.

Distributionally identical to the host path: node picked uniformly among
occupied slots, subtree and its params regenerated from the prior, Hastings
correction ``log|T| - log|T'|``; the leaf swap and the birth/death move as
in ``structures.py``.  ``ancestor_table``, ``config_arrays`` and
``device_prior_arrays`` are deterministic and equal the JAX package's bit
for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import GPConfig
from .structures import CONST, CP, EMPTY, GE, PERIODIC, PLUS, TIMES

__all__ = [
    "MOVE_PROBS", "ConfigArrays", "config_arrays", "ancestor_table",
    "device_prior_arrays", "device_propose", "device_propose_leaf",
    "device_propose_birth_death", "device_propose_mixed",
]

# Random-scan move mixture: subtree regeneration, leaf-type swap,
# birth/death (the host engine's ``propose_batch`` uses the same weights).
MOVE_PROBS = (0.4, 0.3, 0.3)

_LOG2 = math.log(2.0)
_HALF_LOG_2PI = np.float32(0.5 * math.log(2.0 * math.pi))


def ancestor_table(max_nodes: int) -> np.ndarray:
    """Static (max_nodes, levels) table: row j = [j, parent(j), ..., root],
    padded with -1.  Slot j is in the subtree rooted at v iff v appears in
    row j."""
    levels = int(math.log2(max_nodes + 1))
    out = np.full((max_nodes, levels), -1, dtype=np.int32)
    for j in range(max_nodes):
        a, k = j, 0
        while True:
            out[j, k] = a
            if a == 0:
                break
            a = (a - 1) // 2
            k += 1
    return out


class ConfigArrays(NamedTuple):
    """GPConfig lowered to tensors on one device (the JAX package's fields,
    float32)."""

    leaf_logits: torch.Tensor
    op_logits: torch.Tensor
    wc_mu: torch.Tensor
    wc_sigma: torch.Tensor
    period_mu: torch.Tensor
    period_sigma: torch.Tensor
    gamma_mu: torch.Tensor
    gamma_sigma: torch.Tensor
    move_probs: torch.Tensor


def config_arrays(config: GPConfig, device="cuda") -> ConfigArrays:
    """``config`` lowered to float32 tensors on ``device``."""
    leaf = np.asarray(config.node_dist_leaf, dtype=np.float32)
    if config.changepoints:
        op = np.asarray(config.node_dist_cp, dtype=np.float32)
    else:
        op = np.concatenate(
            [np.asarray(config.node_dist_nocp, dtype=np.float32), [0.0]]
        ).astype(np.float32)
    with np.errstate(divide="ignore"):
        leaf_logits, op_logits = np.log(leaf), np.log(op)
    pr = config.prior

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return ConfigArrays(
        t(leaf_logits), t(op_logits),
        t(pr["wildcard"]["mu"]), t(pr["wildcard"]["sigma"]),
        t(pr["period"]["mu"]), t(pr["period"]["sigma"]),
        t(pr["gamma"]["mu"]), t(pr["gamma"]["sigma"]),
        t(MOVE_PROBS),
    )


def device_prior_arrays(types, cfg: ConfigArrays):
    """(mu, sigma, active) float32 (..., N, 3) for the trees' param slots.

    Device analog of ``structures.prior_arrays``: the period slot of a
    Periodic node and the gamma slot of a GammaExponential node take their
    own priors, every other active slot the wildcard prior.
    """
    n_slots = torch.zeros_like(types)
    for code, k in ((1, 1), (2, 2), (3, 2), (4, 3), (5, 3), (8, 2)):
        n_slots = torch.where(types == code, k, n_slots)
    slot_idx = torch.arange(3, device=types.device)
    active = (slot_idx < n_slots[..., None]).to(torch.float32)
    shape = tuple(types.shape) + (3,)
    t = types[..., None]
    is_period = (t == PERIODIC) & (slot_idx == 1)
    is_gamma = (t == GE) & (slot_idx == 1)
    mu = torch.where(is_period, cfg.period_mu, cfg.wc_mu.expand(shape))
    sigma = torch.where(is_period, cfg.period_sigma,
                        cfg.wc_sigma.expand(shape))
    mu = torch.where(is_gamma, cfg.gamma_mu, mu)
    sigma = torch.where(is_gamma, cfg.gamma_sigma, sigma)
    return mu, sigma, active


# ------------------------------------------------------------------ draws


def _categorical(gen, logits, shape):
    """Categorical draws from ``logits`` by inverting the normalised CDF:
    a zero-mass category has a flat step and is never drawn."""
    cdf = torch.cumsum(torch.softmax(logits, -1), -1)
    cdf = cdf / cdf[-1]
    u = torch.rand(shape, generator=gen, device=logits.device)
    return torch.searchsorted(cdf, u.reshape(-1), right=True).reshape(shape)


def _pick(u, sel):
    """Uniform choice among the True slots of each row of ``sel`` (P, N)
    from the uniforms ``u`` (P,); 0 where a row has none.  Returns
    (slot (P,) int64, count (P,) int64)."""
    cnt = sel.sum(-1)
    k = torch.minimum(torch.floor(u * cnt).long(), (cnt - 1).clamp_min(0))
    v = (sel.cumsum(-1) <= k[:, None]).sum(-1)
    return torch.where(cnt > 0, v, 0), cnt


def _sample_types(gen, cfg: ConfigArrays, P: int, N: int):
    """A node type for every slot of every particle from the PCFG: the op
    distribution (leaf, plus, times, changepoint) with the leaf expanded,
    and a leaf on the bottom heap level."""
    dev = cfg.leaf_logits.device
    leaf = 1 + _categorical(gen, cfg.leaf_logits, (P, N))
    choice = _categorical(gen, cfg.op_logits, (P, N))
    # choice 1, 2, 3 -> PLUS, TIMES, CP
    t = torch.where(choice == 0, leaf, choice + (PLUS - 1))
    at_max = (2 * torch.arange(N, device=dev) + 1) >= N
    return torch.where(at_max, leaf, t).to(torch.int32)


def _heap_levels(N: int, device):
    """The slots of each heap level, top down, as index tensors made on
    ``device`` (no host-to-device copy, so nothing waits)."""
    return [torch.arange(2 ** lev - 1, 2 ** (lev + 1) - 1, device=device)
            for lev in range(int(math.log2(N + 1)))]


def _is_binary(t):
    return (t == PLUS) | (t == TIMES) | (t == CP)


def _regen_subtree(types, sampled, root, in_sub_root):
    """Fill the (cleared) subtree at ``root`` (P,) from ``sampled``,
    top-down: a slot takes its draw if it is the root, or lies in the
    subtree below a binary parent."""
    out = types.clone()
    for lev, s in enumerate(_heap_levels(types.shape[1], types.device)):
        if lev == 0:
            need = (root == 0)[:, None]
        else:
            parent_binary = _is_binary(out[:, (s - 1) // 2])
            need = (s[None, :] == root[:, None]) | (
                in_sub_root[:, s] & parent_binary)
        out[:, s] = torch.where(need, sampled[:, s], out[:, s])
    return out


def _in_subtree_matrix(anc, N):
    """bool (N, N): entry (j, v) -- slot j lies in the subtree rooted at v."""
    v = torch.arange(N, device=anc.device)
    return (anc[:, :, None] == v[None, None, :]).any(1)


def _fresh_params(types, params, cfg, gen, fresh, base=None):
    """Prior draws on the active slots of ``fresh`` (P, N), zero on its
    inactive slots, ``base`` (default ``params``) elsewhere."""
    mu, sigma, active = device_prior_arrays(types, cfg)
    eps = torch.randn(params.shape, generator=gen, device=params.device)
    fresh3 = fresh[:, :, None]
    base = params if base is None else base
    return torch.where(fresh3 & (active > 0), mu + sigma * eps,
                       torch.where(fresh3, torch.zeros_like(base), base))


# -------------------------------------------------------------- proposals


def device_propose(types, params, gen, cfg: ConfigArrays, anc):
    """Subtree-regeneration proposals for every particle.

    Returns (types', params', log_hastings (P,)).
    """
    P, N = types.shape
    u_pick = torch.rand(P, generator=gen, device=types.device)
    occupied = types != EMPTY
    v, n_old = _pick(u_pick, occupied)
    in_subtree = _in_subtree_matrix(anc, N).T[v]                  # (P, N)
    sampled = _sample_types(gen, cfg, P, N)
    new_types = torch.where(in_subtree, EMPTY, types)
    new_types = _regen_subtree(new_types, sampled, v, in_subtree)
    new_params = _fresh_params(new_types, params, cfg, gen, in_subtree)
    n_new = (new_types != EMPTY).sum(-1)
    log_h = (torch.log(n_old.to(torch.float32))
             - torch.log(n_new.to(torch.float32)))
    return new_types, new_params, log_h


def device_propose_leaf(types, params, gen, cfg: ConfigArrays):
    """Leaf-type-swap proposals: pick a leaf uniformly, redraw its type from
    ``node_dist_leaf`` and its params from the prior; log_hastings = 0."""
    P, N = types.shape
    dev = types.device
    u_pick = torch.rand(P, generator=gen, device=dev)
    is_leaf = (types >= CONST) & (types <= PERIODIC)
    v, _ = _pick(u_pick, is_leaf)
    new_leaf = (1 + _categorical(gen, cfg.leaf_logits, (P,))).to(types.dtype)
    at_v = torch.arange(N, device=dev)[None, :] == v[:, None]
    new_types = torch.where(at_v, new_leaf[:, None], types)
    new_params = _fresh_params(new_types, params, cfg, gen, at_v)
    return new_types, new_params, torch.zeros(P, device=dev)


def _bottom_mask(N: int, device) -> torch.Tensor:
    """bool (N,): slot sits on the bottom heap level (slots (N - 1) / 2 on
    of a complete heap)."""
    return torch.arange(N, device=device) >= (N - 1) // 2


def _tree_log_prior(types, cfg: ConfigArrays, slot_mask=None):
    """Structure log-prior per tree, slot-decomposed: a leaf above the
    bottom level costs log p(leaf-choice) + log p(type), at the bottom only
    the type term; an internal node its op probability.  ``slot_mask``
    restricts it to a subtree."""
    N = types.shape[-1]
    bottom = _bottom_mask(N, types.device)
    is_leaf = (types >= 1) & (types <= PERIODIC)
    is_bin = (types >= PLUS) & (types <= CP)
    zero = torch.zeros((), device=types.device)
    leaf_lp = cfg.leaf_logits[(types - 1).clamp(0, 4).long()]
    lp = torch.where(
        is_leaf, leaf_lp + torch.where(bottom, zero, cfg.op_logits[0]), zero)
    lp = lp + torch.where(
        is_bin, cfg.op_logits[(types - PLUS + 1).clamp(1, 3).long()], zero)
    if slot_mask is not None:
        lp = torch.where(slot_mask, lp, zero)
    return lp.sum(-1)


def _params_log_prior(types, params, cfg: ConfigArrays, slot_mask=None):
    """Normal log-density of the unconstrained params on active slots."""
    mu, sigma, active = device_prior_arrays(types, cfg)
    z = (params - mu) / sigma
    lp = -0.5 * z * z - torch.log(sigma) - _HALF_LOG_2PI
    w = active if slot_mask is None else active * slot_mask[:, :, None]
    return (w * lp).sum((-2, -1))


def _relocate(types, params, ni, move):
    """Move slot j of each tree to heap index ``ni[j]`` where ``move[j]``
    (one source per destination).  Returns (types, params, has_destination),
    each of the trees' shape, zero where nothing lands."""
    P, N = types.shape
    dst = torch.where(move & (ni < N), ni, N).long()    # N: a spare column
    rel_t = torch.zeros((P, N + 1), dtype=types.dtype, device=types.device)
    rel_t.scatter_(1, dst, types)
    rel_p = torch.zeros((P, N + 1, 3), dtype=params.dtype,
                        device=params.device)
    rel_p.scatter_(1, dst[:, :, None].expand(P, N, 3), params)
    has = torch.zeros((P, N + 1), dtype=torch.bool, device=types.device)
    has.scatter_(1, dst, move)
    return rel_t[:, :N], rel_p[:, :N], has[:, :N]


def _down_map(v, target_v, N):
    """New heap index of every slot of the subtree at ``v`` (P,) when it is
    relocated so its root lands at ``target_v`` (P,); -1 outside the
    subtree (children follow parents, level by level)."""
    ni = torch.full((v.shape[0], N), -1, dtype=torch.long, device=v.device)
    for lev, s in enumerate(_heap_levels(N, v.device)):
        if lev == 0:
            val = torch.where(v == 0, target_v, -1)[:, None]
        else:
            parent = (s - 1) // 2
            b = s - (2 * parent + 1)
            pni = ni[:, parent]
            val = torch.where(
                s[None, :] == v[:, None], target_v[:, None],
                torch.where(pni >= 0, 2 * pni + 1 + b, -1))
        ni[:, s] = val
    return ni


def device_propose_birth_death(types, params, gen, cfg: ConfigArrays, anc):
    """Reversible birth/death dimension moves (mirror of
    ``structures.propose_birth_death``).

    A 50/50 coin per particle: birth inserts an internal op above a
    feasible node, relocating the existing subtree intact and prior-sampling
    a sibling; death promotes one child of an internal node and deletes the
    other.  Hastings corrections are accounted numerically (full structure
    + param prior log-densities plus the exact proposal densities); an
    infeasible submove leaves the tree unchanged with log_hastings = -inf.
    """
    P, N = types.shape
    dev = types.device
    in_sub = _in_subtree_matrix(anc, N)                          # (j, v)
    in_sub_t = in_sub.T                                           # (v, j)
    bottom = _bottom_mask(N, dev)
    occupied = types != EMPTY
    is_bin = (types >= PLUS) & (types <= CP)
    bin_logp = torch.log_softmax(cfg.op_logits[1:], -1)
    iota = torch.arange(N, device=dev)[None, :]
    neg_inf = torch.full((), -math.inf, device=dev)

    do_birth = torch.rand(P, generator=gen, device=dev) < 0.5
    u_pick = torch.rand(P, generator=gen, device=dev)
    side = (torch.rand(P, generator=gen, device=dev) < 0.5).long()

    lp_t = _tree_log_prior(types, cfg) + _params_log_prior(types, params, cfg)

    # ---------- birth ----------
    # feasible roots: occupied, no occupied bottom-level node in the subtree
    has_bottom = ((occupied & bottom)[:, :, None] & in_sub[None]).any(1)
    feas = occupied & ~has_bottom
    v, F = _pick(u_pick, feas)
    birth_ok = F > 0
    oi = _categorical(gen, cfg.op_logits[1:], (P,))
    o = (oi + PLUS).to(types.dtype)                    # PLUS, TIMES or CP
    target_v = 2 * v + 1 + side
    sib = (2 * v + 2 - side).clamp_max(N - 1)

    in_sub_v = in_sub_t[v]
    ni = _down_map(v, target_v, N)
    rel_t, rel_p, has_dst = _relocate(types, params, ni,
                                      (ni >= 0) & occupied & in_sub_v)
    bt = torch.where(has_dst, rel_t,
                     torch.where(in_sub_v, EMPTY, types))
    bp = torch.where(has_dst[:, :, None], rel_p,
                     torch.where(in_sub_v[:, :, None], 0.0, params))
    at_v = iota == v[:, None]
    bt = torch.where(at_v, o[:, None], bt)
    in_sub_sib = in_sub_t[sib]
    bt = _regen_subtree(bt, _sample_types(gen, cfg, P, N), sib, in_sub_sib)
    bp = _fresh_params(bt, params, cfg, gen, in_sub_sib | at_v, base=bp)

    lp_bt = _tree_log_prior(bt, cfg) + _params_log_prior(bt, bp, cfg)
    D2 = ((bt >= PLUS) & (bt <= CP)).sum(-1)
    b_q_fwd = (-torch.log(F.to(torch.float32)) + bin_logp[oi] - _LOG2
               + _tree_log_prior(bt, cfg, in_sub_sib)
               + _params_log_prior(bt, bp, cfg, in_sub_sib)
               + _params_log_prior(bt, bp, cfg, at_v))
    b_q_rev = -torch.log(D2.to(torch.float32)) - _LOG2
    b_log_h = torch.where(birth_ok, (lp_bt - lp_t) + (b_q_rev - b_q_fwd),
                          neg_inf)

    # ---------- death ----------
    u, D = _pick(u_pick, is_bin)
    death_ok = D > 0
    child = (2 * u + 1 + side).clamp_max(N - 1)
    other = (2 * u + 2 - side).clamp_max(N - 1)
    in_sub_u, in_sub_child = in_sub_t[u], in_sub_t[child]
    in_sub_other = in_sub_t[other]
    ni_d = _down_map(child, u, N)
    rel_t, rel_p, has_dst = _relocate(types, params, ni_d,
                                      (ni_d >= 0) & occupied & in_sub_child)
    dt = torch.where(has_dst, rel_t, torch.where(in_sub_u, EMPTY, types))
    dp = torch.where(has_dst[:, :, None], rel_p,
                     torch.where(in_sub_u[:, :, None], 0.0, params))

    lp_dt = _tree_log_prior(dt, cfg) + _params_log_prior(dt, dp, cfg)
    occ2 = dt != EMPTY
    has_bottom2 = ((occ2 & bottom)[:, :, None] & in_sub[None]).any(1)
    F2 = (occ2 & ~has_bottom2).sum(-1)
    at_u = iota == u[:, None]
    oi_old = (types.gather(1, u[:, None])[:, 0] - PLUS).clamp(0, 2).long()
    d_q_fwd = -torch.log(D.to(torch.float32)) - _LOG2
    d_q_rev = (-torch.log(F2.to(torch.float32)) + bin_logp[oi_old] - _LOG2
               + _tree_log_prior(types, cfg, in_sub_other)
               + _params_log_prior(types, params, cfg, in_sub_other)
               + _params_log_prior(types, params, cfg, at_u))
    d_log_h = torch.where(death_ok, (lp_dt - lp_t) + (d_q_rev - d_q_fwd),
                          neg_inf)

    ok = torch.where(do_birth, birth_ok, death_ok)
    new_types = torch.where(do_birth[:, None], bt, dt)
    new_params = torch.where(do_birth[:, None, None], bp, dp)
    new_types = torch.where(ok[:, None], new_types, types)
    new_params = torch.where(ok[:, None, None], new_params, params)
    log_h = torch.where(do_birth, b_log_h, d_log_h)
    return new_types, new_params, log_h


def device_propose_mixed(types, params, gen, cfg: ConfigArrays, anc):
    """Random-scan mixture of the three involutive moves
    (``cfg.move_probs`` = regeneration, leaf swap, birth/death), one move
    per particle.  All three are built for every particle and one is
    selected, so each particle draws the same variates."""
    P = types.shape[0]
    r = torch.rand(P, generator=gen, device=types.device)
    p_regen, p_leaf = cfg.move_probs[0], cfg.move_probs[1]
    t1, p1, h1 = device_propose(types, params, gen, cfg, anc)
    t2, p2, h2 = device_propose_leaf(types, params, gen, cfg)
    t3, p3, h3 = device_propose_birth_death(types, params, gen, cfg, anc)
    use_leaf = (r >= p_regen) & (r < p_regen + p_leaf)
    use_bd = r >= p_regen + p_leaf
    new_types = torch.where(use_bd[:, None], t3,
                            torch.where(use_leaf[:, None], t2, t1))
    new_params = torch.where(use_bd[:, None, None], p3,
                             torch.where(use_leaf[:, None, None], p2, p1))
    log_h = torch.where(use_bd, h3, torch.where(use_leaf, h2, h1))
    return new_types, new_params, log_h
