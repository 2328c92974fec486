"""Port parity: device proposals and the device-proposal SMC engine.

* ``ancestor_table``, ``config_arrays`` and ``device_prior_arrays`` are
  deterministic and bitwise the JAX package's; so are the subtree
  relocation (``_down_map``, ``_relocate``) of both dimension submoves,
  and the structure and parameter log-priors the Hastings terms are built
  from agree with the JAX package's to rounding (rtol 1e-6).
* The birth/death Hastings term of every finite proposal equals the JAX
  package's for the same move (rtol 1e-5): a death's directly, a birth's
  as minus its reverse death's.
* Proposal chains on the port (the JAX package's checks in
  ``tests/test_device_engine.py``): every proposal is a valid heap tree,
  the default prior's zero-mass leaves never appear, no changepoint appears
  when changepoints are disabled, and a constant-likelihood chain of
  birth/death moves (and of the three-move mixture) keeps the PCFG prior:
  its mean node count is the prior's within 4 standard errors, and its
  node count and type frequencies agree with the JAX package's chain of
  the same move.
* The carried-state contract of the device sweep: the LML carried out of
  ``run_hmc`` equals a fresh evaluation of its state, and a sweep that
  carries value and gradient across moves equals one that recomputes them
  on the same generator stream (the JAX package's tolerances).
* The device fit's reweight guard: a particle whose stored LML is at the
  ``-1e10`` sentinel loses its weight.  Without moves, the device fit's
  reweight, ESS gate and systematic resample equal the JAX package's
  ``smc_fit_device`` step by step, given JAX's resample uniforms.
* The device and host engines agree on a tiny fit, as in the JAX package.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.inference import device_smc as jdsmc
from nowcastautogp_tpu.models import structures_device as jsd
from nowcastautogp_tpu.models.config import GPConfig as JGPConfig
from nowcastautogp_tpu_torch.inference.device_smc import (
    rejuvenation_sweep, smc_fit_device,
)
from nowcastautogp_tpu_torch.inference.hmc import run_hmc
from nowcastautogp_tpu_torch.models import structures_device as sd
from nowcastautogp_tpu_torch.models.config import GPConfig
from nowcastautogp_tpu_torch.models.structures import (
    CONST, CP, EMPTY, PLUS, SE, TIMES, count_nodes, prior_arrays,
    sample_particle,
)
from nowcastautogp_tpu_torch.ops.lml import gp_lml_batched

torch.set_num_threads(1)

HP = dict(step_size=0.01, step_jitter=0.0, jitter=1e-5, noise_mu=-2.0,
          noise_sigma=1.0, infer_noise=1.0)


def _valid_tree(t) -> bool:
    n = t.shape[0]
    if t[0] == EMPTY:
        return False
    for i in range(n):
        li, ri = 2 * i + 1, 2 * i + 2
        if t[i] in (PLUS, TIMES, CP):
            if li >= n or t[li] == EMPTY or t[ri] == EMPTY:
                return False
        elif li < n and (t[li] != EMPTY or t[ri] != EMPTY):
            return False
    return True


def _particles(cfg, P, seed):
    rng = np.random.default_rng(seed)
    ts, ps = zip(*[sample_particle(rng, cfg)[:2] for _ in range(P)])
    return torch.as_tensor(np.stack(ts)), torch.as_tensor(np.stack(ps))


def _tools(cfg):
    return (sd.config_arrays(cfg, "cpu"),
            torch.as_tensor(sd.ancestor_table(cfg.max_nodes)))


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


@pytest.mark.parametrize("max_nodes", [7, 15, 31, 63])
def test_ancestor_table_bitwise_jax(max_nodes):
    got = sd.ancestor_table(max_nodes)
    want = jsd.ancestor_table(max_nodes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("changepoints", [True, False])
def test_config_arrays_bitwise_jax(changepoints):
    kw = dict(changepoints=changepoints, max_depth=4)
    got = sd.config_arrays(GPConfig(**kw), "cpu")
    want = jsd.config_arrays(JGPConfig(**kw))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert g.numpy().tobytes() == w.tobytes(), name


def _subtree_masks(types, anc, seed):
    """Per particle: a uniformly chosen occupied slot v and the bool mask of
    the subtree at v, (P,) and (P, N)."""
    N = types.shape[1]
    u = torch.as_tensor(np.random.default_rng(seed).random(types.shape[0]),
                        dtype=torch.float32)
    v, _ = sd._pick(u, types != EMPTY)
    return v, sd._in_subtree_matrix(anc, N).T[v]


def test_tree_and_params_log_prior_match_jax():
    """The birth/death Hastings terms are built from these two densities,
    whole and restricted to a subtree or one slot: the JAX package's,
    vmapped, to rounding (rtol 1e-6), with parameters drawn on every slot
    so the active-slot masking is exercised, under a prior whose every leaf
    type has mass and whose scales are not 1."""
    prior = {"gamma": {"mu": 0.2, "sigma": 1.5},
             "period": {"mu": -1.2, "sigma": 0.4},
             "wildcard": {"mu": 0.3, "sigma": 0.7}}
    kw = dict(max_depth=5, node_dist_leaf=(0.1, 0.2, 0.3, 0.2, 0.2))
    cfg = GPConfig(prior=prior, **kw)
    ca, anc = _tools(cfg)
    jca = jsd.config_arrays(JGPConfig(prior=prior, **kw))
    types, _ = _particles(cfg, 64, seed=13)
    params = torch.as_tensor(np.random.default_rng(14).normal(
        0.0, 2.0, (64, cfg.max_nodes, 3)).astype(np.float32))
    v, sub = _subtree_masks(types, anc, seed=15)
    at_v = torch.arange(cfg.max_nodes)[None, :] == v[:, None]
    jt, jp = jnp.asarray(types.numpy()), jnp.asarray(params.numpy())
    tree = jax.jit(jax.vmap(jsd._tree_log_prior_device, in_axes=(0, None, 0)))
    par = jax.jit(jax.vmap(jsd._params_log_prior_device,
                           in_axes=(0, 0, None, 0)))
    ones = torch.ones_like(sub)
    for mask in (ones, sub, at_v):
        jm = jnp.asarray(mask.numpy())
        got_t = sd._tree_log_prior(types, ca, mask)
        got_p = sd._params_log_prior(types, params, ca, mask)
        np.testing.assert_allclose(got_t.numpy(), tree(jt, jca, jm),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_p.numpy(), par(jt, jp, jca, jm),
                                   rtol=1e-6, atol=1e-5)
    # no mask is the whole tree
    np.testing.assert_array_equal(sd._tree_log_prior(types, ca).numpy(),
                                  sd._tree_log_prior(types, ca, ones).numpy())


def test_down_map_and_relocate_match_jax():
    """The subtree relocation of both submoves -- birth: the subtree at v
    moves down to child 2v + 1 + side; death: the subtree at a child moves
    up to its parent -- equals the JAX package's ``_down_map_device`` and
    ``_relocate``, vmapped, bitwise."""
    cfg = GPConfig(max_depth=5)
    N = cfg.max_nodes
    ca, anc = _tools(cfg)
    types, params = _particles(cfg, 64, seed=16)
    rng = np.random.default_rng(17)
    side = torch.as_tensor(rng.integers(0, 2, 64))
    v, sub_v = _subtree_masks(types, anc, seed=18)
    down = jax.jit(jax.vmap(lambda a, b: jsd._down_map_device(a, b, N)))
    relocate = jax.jit(jax.vmap(jsd._relocate))
    in_sub_t = sd._in_subtree_matrix(anc, N).T
    child = (2 * v + 1 + side).clamp_max(N - 1)
    maps = []
    for root, target in ((v, 2 * v + 1 + side), (child, v)):
        ni = sd._down_map(root, target, N)
        maps.append(ni)
        jni = down(jnp.asarray(root.numpy(), jnp.int32),
                   jnp.asarray(target.numpy(), jnp.int32))
        np.testing.assert_array_equal(ni.numpy(), np.asarray(jni))
        move = (ni >= 0) & (types != EMPTY) & in_sub_t[root]
        got = sd._relocate(types, params, ni, move)
        want = relocate(jnp.asarray(types.numpy()),
                        jnp.asarray(params.numpy()), jni,
                        jnp.asarray(move.numpy()))
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # some births push a slot off the heap, which the relocation drops
    assert bool((maps[0] >= N).any())


def test_birth_death_hastings_match_jax():
    """Every finite birth/death proposal of the port, held against the JAX
    package's move on the same tree.  A death is deterministic given its
    node and side, so JAX's death proposals from the same tree (256 keys
    each, vmapped) must contain the port's result, tree and parameters
    bitwise, with the same log-Hastings term (rtol 1e-5).  A birth draws a
    new sibling subtree, so it is held through its reverse: JAX's death
    from the port's result back to the original tree must carry minus the
    port's term."""
    cfg = GPConfig(max_depth=4)
    ca, anc = _tools(cfg)
    jca = jsd.config_arrays(JGPConfig(max_depth=4))
    types, params = _particles(cfg, 64, seed=19)
    starts, ends, terms, kinds = [], [], [], []
    gen = _gen(20)
    for _ in range(2):
        t2, p2, lh = sd.device_propose_birth_death(types, params, gen, ca,
                                                   anc)
        for i in np.flatnonzero(torch.isfinite(lh).numpy()):
            grow = count_nodes(t2[i].numpy()) - count_nodes(types[i].numpy())
            assert grow != 0
            starts.append((types[i], params[i]))
            ends.append((t2[i], p2[i]))
            terms.append(float(lh[i]))
            kinds.append("birth" if grow > 0 else "death")
    assert {"birth", "death"} <= set(kinds) and len(kinds) > 60
    # JAX proposes from the start of a death and from the end of a birth
    src = [s if k == "death" else e
           for s, e, k in zip(starts, ends, kinds)]
    jt = jnp.asarray(np.stack([t.numpy() for t, _ in src]))
    jp = jnp.asarray(np.stack([p.numpy() for _, p in src]))
    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    prop = jax.jit(jax.vmap(
        jax.vmap(jsd.device_propose_birth_death,
                 in_axes=(None, None, 0, None, None)),
        in_axes=(0, 0, None, None, None)))
    j_t, j_p, j_lh = (np.asarray(a) for a in prop(
        jt, jp, keys, jca, jnp.asarray(anc.numpy())))
    for b, (start, end, term, kind) in enumerate(zip(starts, ends, terms,
                                                     kinds)):
        want_t, want_p = end if kind == "death" else start
        hit = (np.all(j_t[b] == want_t.numpy(), axis=1)
               & np.all(j_p[b] == want_p.numpy(), axis=(1, 2)))
        assert hit.any(), (b, kind)
        ref = j_lh[b][hit]
        assert np.all(ref == ref[0])
        want = ref[0] if kind == "death" else -ref[0]
        np.testing.assert_allclose(term, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kind} {b}")


def test_device_prior_arrays_bitwise_jax():
    cfg, jcfg = GPConfig(max_depth=5), JGPConfig(max_depth=5)
    types, _ = _particles(cfg, 64, seed=3)
    got = sd.device_prior_arrays(types, sd.config_arrays(cfg, "cpu"))
    want = jax.jit(jax.vmap(jsd.device_prior_arrays, in_axes=(0, None)))(
        jnp.asarray(types.numpy()), jsd.config_arrays(jcfg))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # and the host prior where a slot is active
    mu_h, sg_h, act_h = prior_arrays(types.numpy(), cfg)
    np.testing.assert_array_equal(got[2].numpy(), act_h)
    sel = act_h > 0
    np.testing.assert_array_equal(got[0].numpy()[sel], mu_h[sel])
    np.testing.assert_array_equal(got[1].numpy()[sel], sg_h[sel])


@pytest.mark.parametrize("move", ["regen", "leaf", "birth_death", "mixed"])
def test_proposals_are_valid_trees(move):
    """A 40-step chain of one move (every proposal kept) on 32 depth-5
    particles: valid heaps, finite Hastings terms on the regeneration and
    leaf moves, and never a zero-mass leaf of the default prior."""
    cfg = GPConfig(max_depth=5)
    ca, anc = _tools(cfg)
    types, params = _particles(cfg, 32, seed=0)
    gen = _gen(1)
    for _ in range(40):
        if move == "regen":
            t2, p2, lh = sd.device_propose(types, params, gen, ca, anc)
        elif move == "leaf":
            t2, p2, lh = sd.device_propose_leaf(types, params, gen, ca)
        elif move == "birth_death":
            t2, p2, lh = sd.device_propose_birth_death(types, params, gen,
                                                       ca, anc)
        else:
            t2, p2, lh = sd.device_propose_mixed(types, params, gen, ca, anc)
        tn = t2.numpy()
        assert all(_valid_tree(t) for t in tn)
        assert not np.any((tn == CONST) | (tn == SE))
        assert t2.dtype == types.dtype and p2.shape == params.shape
        if move in ("regen", "leaf"):
            assert torch.isfinite(lh).all()
        # an empty slot holds zero parameters
        assert np.all(p2.numpy()[tn == EMPTY] == 0.0)
        keep = torch.isfinite(lh)
        types = torch.where(keep[:, None], t2, types)
        params = torch.where(keep[:, None, None], p2, params)


def test_no_changepoints_when_disabled():
    cfg = GPConfig(changepoints=False, max_depth=5)
    ca, anc = _tools(cfg)
    types, params = _particles(cfg, 32, seed=1)
    gen = _gen(2)
    for _ in range(30):
        types, params, _ = sd.device_propose_mixed(types, params, gen, ca, anc)
        tn = types.numpy()
        assert not np.any(tn == CP)
        assert all(_valid_tree(t) for t in tn)


def _jax_chain(move, types, params, M):
    """The JAX package's constant-likelihood chain of ``move``, as
    ``tests/test_device_engine.py`` runs it: final trees (P, N)."""
    P = types.shape[0]
    jca = jsd.config_arrays(JGPConfig(max_depth=4))
    anc = jnp.asarray(jsd.ancestor_table(15))
    prop = jax.vmap(getattr(jsd, "device_propose_" + move),
                    in_axes=(0, 0, 0, None, None))

    @jax.jit
    def chain(ty, pa, key):
        def step(carry, k):
            ty, pa = carry
            k1, k2 = jax.random.split(k)
            t2, p2, lh = prop(ty, pa, jax.random.split(k1, P), jca, anc)
            acc = jnp.log(jax.random.uniform(k2, (P,))) < lh
            return (jnp.where(acc[:, None], t2, ty),
                    jnp.where(acc[:, None, None], p2, pa)), None
        return jax.lax.scan(step, (ty, pa), jax.random.split(key, M))[0][0]

    return np.asarray(chain(jnp.asarray(types.numpy()),
                            jnp.asarray(params.numpy()),
                            jax.random.PRNGKey(5)))


def _type_counts(trees):
    return np.bincount(trees[trees != EMPTY].ravel(), minlength=9)[1:]


@pytest.mark.parametrize("move", ["birth_death", "mixed"])
def test_chain_keeps_the_prior(move):
    """Constant likelihood: the MH chain of the move must sample the PCFG
    prior, so after 60 steps from prior draws the mean node count matches
    fresh prior draws (as ``tests/test_device_engine.py`` checks the JAX
    package's birth/death chain) and the active parameters stay N(0, 1)
    once standardized.  Against the JAX package's chain of the same move
    from the same trees: mean node count within 4 standard errors, and node
    type frequencies by a chi-squared test of homogeneity (p > 1e-3)."""
    cfg = GPConfig(max_depth=4)
    ca, anc = _tools(cfg)
    P, M = 200, 60
    types, params = _particles(cfg, P, seed=21)
    jtf = _jax_chain(move, types, params, M)
    gen = _gen(5)
    propose = (sd.device_propose_birth_death if move == "birth_death"
               else sd.device_propose_mixed)
    for _ in range(M):
        t2, p2, lh = propose(types, params, gen, ca, anc)
        acc = torch.log(torch.rand(P, generator=gen)) < lh
        types = torch.where(acc[:, None], t2, types)
        params = torch.where(acc[:, None, None], p2, params)
    tf = types.numpy()
    assert all(_valid_tree(t) for t in tf)
    counts = [count_nodes(t) for t in tf]
    rng = np.random.default_rng(99)
    ref = [count_nodes(sample_particle(rng, cfg)[0]) for _ in range(4000)]
    se = np.hypot(np.std(counts) / np.sqrt(P), np.std(ref) / np.sqrt(4000))
    z = (np.mean(counts) - np.mean(ref)) / se
    assert abs(z) < 4.0, (np.mean(counts), np.mean(ref), z)
    jcounts = [count_nodes(t) for t in jtf]
    se = np.hypot(np.std(counts), np.std(jcounts)) / np.sqrt(P)
    z = (np.mean(counts) - np.mean(jcounts)) / se
    assert abs(z) < 4.0, (np.mean(counts), np.mean(jcounts), z)
    table = np.stack([_type_counts(tf), _type_counts(jtf)])
    table = table[:, table.sum(0) > 0]
    assert stats.chi2_contingency(table)[1] > 1e-3, table
    mu, sg, act = sd.device_prior_arrays(types, ca)
    zp = ((params - mu) / sg)[act > 0]
    k = zp.numel()
    assert abs(float(zp.mean())) < 5.0 / np.sqrt(k)
    assert abs(float(zp.var()) - 1.0) < 5.0 * np.sqrt(2.0 / k)


def _batch(P, cap, n_active, freq, seed0=0):
    cfg = GPConfig(max_depth=3)
    parts = [sample_particle(np.random.default_rng(seed0 + i), cfg)
             for i in range(P)]
    types = torch.as_tensor(np.stack([p[0] for p in parts]))
    params = torch.as_tensor(np.stack([p[1] for p in parts]))
    ln = torch.full((P,), -2.0)
    xs = np.linspace(0, 1, cap, dtype=np.float32)
    x = torch.as_tensor(xs).expand(P, cap)
    y = torch.as_tensor(np.sin(freq * xs).astype(np.float32)).expand(P, cap)
    mask = torch.as_tensor((np.arange(cap) < n_active).astype(np.float32)
                           ).expand(P, cap)
    return cfg, types, params, ln, x, y, mask


def test_carried_lml_matches_fresh_evaluation():
    cfg, types, params, ln, x, y, mask = _batch(3, 64, 40, 7.0)
    mu, sg, act = (torch.as_tensor(a) for a in prior_arrays(types.numpy(),
                                                            cfg))
    p, lnb, lml, _, _, (U, g_p, g_n) = run_hmc(
        types, params, ln, mu, sg, act, x, y, mask, _gen(7), n_steps=3,
        n_leapfrog=2, **HP)
    assert torch.isfinite(p).all()
    with torch.no_grad():
        fresh = gp_lml_batched(types, p, lnb, x, y, mask, HP["jitter"])
    torch.testing.assert_close(lml, fresh, rtol=2e-4, atol=2e-3)
    assert U.shape == lml.shape and g_p.shape == p.shape
    assert g_n.shape == lnb.shape


def test_sweep_matches_per_move_recompute():
    """The sweep carries potential and gradients across moves; a reference
    that evaluates each proposal's LML alone and lets every HMC start from
    a fresh gradient, on the same generator stream, must agree."""
    cfg, types, params, ln, x, y, mask = _batch(4, 32, 24, 5.0)
    ca, anc = _tools(cfg)
    with torch.no_grad():
        lml0 = gp_lml_batched(types, params, ln, x, y, mask, HP["jitter"])
    n_mcmc, n_hmc, n_leapfrog = 4, 2, 2
    got = rejuvenation_sweep(types, params, ln, lml0, x, y, mask, _gen(11),
                             ca, anc, n_mcmc=n_mcmc, n_hmc=n_hmc,
                             n_leapfrog=n_leapfrog, **HP)

    gen = _gen(11)
    t_r, p_r, ln_r, lml_r = types, params, ln, lml0
    scale = torch.ones(4)
    accs = []
    for _ in range(n_mcmc):
        t2, p2, log_h = sd.device_propose_mixed(t_r, p_r, gen, ca, anc)
        with torch.no_grad():
            lml2 = gp_lml_batched(t2, p2, ln_r, x, y, mask, HP["jitter"])
        accept = torch.log(torch.rand(4, generator=gen)) < lml2 - lml_r + log_h
        accs.append(accept.float())
        t_r = torch.where(accept[:, None], t2, t_r)
        p_r = torch.where(accept[:, None, None], p2, p_r)
        lml_r = torch.where(accept, lml2, lml_r)
        mu, sg, act = sd.device_prior_arrays(t_r, ca)
        p_r, ln_r, lml_r, _, scale, _ = run_hmc(
            t_r, p_r, ln_r, mu, sg, act, x, y, mask, gen, n_steps=n_hmc,
            n_leapfrog=n_leapfrog, eps_scale=scale, **HP)
    t_new, p_new, ln_new, lml_new, acc_new, sc_new = got
    torch.testing.assert_close(t_new, t_r, rtol=0, atol=0)
    torch.testing.assert_close(p_new, p_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ln_new, ln_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lml_new, lml_r, rtol=2e-4, atol=2e-3)
    assert abs(float(acc_new) - float(torch.stack(accs).mean())) <= 1e-6
    torch.testing.assert_close(sc_new, scale, rtol=1e-5, atol=0)


def _data(n=30, seed=8):
    rng = np.random.default_rng(seed)
    dates = [dt.date(2023, 1, 2) + dt.timedelta(weeks=i) for i in range(n)]
    obs = 50 * np.exp(0.02 * np.arange(n) + 0.1 * rng.standard_normal(n))
    return ngp.create_transformed_data(dates, obs, transformation=np.log), dates


def test_device_fit_sentinel_guard():
    """A particle whose stored LML sits at the -1e10 sentinel and whose
    next reweight comes back finite must lose the ensemble."""
    data, _ = _data(seed=11)
    m = ngp.GPModel(data.ds, data.y, n_particles=3, seed=5, device="cpu")
    cap = m._cap
    x = m._x_d.expand(3, cap)
    y = m._y_d.expand(3, cap)
    masks = m._tensor((np.arange(cap) < len(data.y))[None].astype(np.float32))
    ca, anc = _tools(m.config)
    lml0 = torch.tensor([-1e10, 0.0, 0.0])
    _, _, _, log_w, _, _, _ = smc_fit_device(
        m._types_d(), m._params_d, m._log_noise_d, torch.zeros(3), lml0,
        m._eps_scale_d, x, y, masks, _gen(0), ca, anc, n_mcmc=0, n_hmc=0,
        n_leapfrog=1, step_size=0.1, step_jitter=0.0, adaptive=False,
        ess_frac=0.0)
    log_w = log_w.numpy().astype(np.float64)
    assert log_w[0] <= -1e9
    assert np.all(np.isfinite(log_w[1:])) and np.all(log_w[1:] > -1e9)
    w = np.exp(log_w - log_w.max())
    assert w[0] / w.sum() < 1e-6


def test_device_fit_without_moves_matches_jax(monkeypatch):
    """With no moves (``n_mcmc = 0``) the device fit is reweight, ESS gate
    and systematic resample over the schedule.  On the same state, with
    particle 0's stored LML at the sentinel, and the port's resample
    uniform set to the JAX package's draw at each step: every step's ESS
    and LML-built log-weights agree (rtol 1e-4, atol 1e-3, the LML
    tolerance), the gates and the resampled particles exactly."""
    cfg, types, params, ln, x, y, _ = _batch(16, 32, 24, 6.0, seed0=40)
    ln = ln + torch.linspace(-0.5, 0.5, 16)
    masks = torch.as_tensor(np.stack(
        [(np.arange(32) < n).astype(np.float32) for n in (10, 14, 18, 24)]))
    ca, anc = _tools(cfg)
    with torch.no_grad():
        lml0 = gp_lml_batched(types, params, ln, x, y, masks[0].expand(16, 32),
                              HP["jitter"])
    lml0[0] = -1e10
    log_w0 = torch.zeros(16)
    eps0 = torch.linspace(0.5, 1.5, 16)
    kw = dict(n_mcmc=0, n_hmc=0, n_leapfrog=1, step_size=0.1,
              step_jitter=0.0, adaptive=False, ess_frac=0.8,
              jitter=HP["jitter"])

    key = jax.random.PRNGKey(3)
    want = jdsmc.smc_fit_device(
        *(jnp.asarray(a.numpy()) for a in (types, params, ln, log_w0, lml0,
                                           eps0, x, y)),
        jnp.asarray(np.broadcast_to(masks.numpy()[:, None], (4, 16, 32))),
        key, jsd.config_arrays(JGPConfig(max_depth=3)),
        jnp.asarray(anc.numpy()), **kw)
    us = []
    for _ in range(4):
        key, k_res, _ = jax.random.split(key, 3)
        us.append(float(jax.random.uniform(k_res)))

    real_rand, fed = torch.rand, iter(us)

    def rand(*size, **kwargs):
        if size == ((),):
            return torch.tensor(next(fed))
        return real_rand(*size, **kwargs)

    monkeypatch.setattr(torch, "rand", rand)
    got = smc_fit_device(types, params, ln, log_w0, lml0, eps0, x, y, masks,
                         _gen(0), ca, anc, **kw)
    monkeypatch.undo()
    assert next(fed, None) is None
    (g_t, g_p, g_ln, g_w, g_lml, g_eps, (g_ess, _, g_low)) = got
    (w_t, w_p, w_ln, w_w, w_lml, w_eps, (w_ess, _, w_low)) = (
        jax.tree_util.tree_map(np.asarray, want))
    assert w_low.any() and not w_low.all()
    np.testing.assert_array_equal(g_low.numpy(), w_low)
    np.testing.assert_allclose(g_ess.numpy(), w_ess, rtol=1e-4)
    for g, w in ((g_t, w_t), (g_p, w_p), (g_ln, w_ln), (g_eps, w_eps)):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in ((g_w, w_w), (g_lml, w_lml)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("biased", [False, True])
def test_device_and_host_engines_agree(biased):
    """Same data, same budgets: the two engines' predictions are in the
    same ballpark (the JAX package's check), both ingest every point and
    keep valid trees and finite weights; ``rejuvenate`` takes the device
    engine too."""
    data, dates = _data()
    kw = dict(n_particles=2, smc_data_proportion=0.34, n_mcmc=2, n_hmc=2,
              biased=biased, device="cpu")
    m_dev = ngp.make_and_fit_model(data, seed=1, engine="device", **kw)
    m_host = ngp.make_and_fit_model(data, seed=1, engine="host", **kw)
    fdates = [dates[-1] + dt.timedelta(weeks=i + 1) for i in range(2)]
    mu_d = ngp.predict_mvn(m_dev, fdates).mean()
    mu_h = ngp.predict_mvn(m_host, fdates).mean()
    np.testing.assert_allclose(mu_d, mu_h, atol=1.0)
    for m in (m_dev, m_host):
        assert m.n_ingested == 30
        assert np.all(np.isfinite(m.log_weight))
        assert all(_valid_tree(t) for t in m._host_types)
    acc = m_dev.rejuvenate(1, 1, engine="device")
    assert 0.0 <= acc <= 1.0
    assert all(_valid_tree(t) for t in m_dev._host_types)
    with pytest.raises(ValueError, match="engine"):
        ngp.fit_smc(m_dev, schedule=[30], n_mcmc=1, n_hmc=1, engine="tpu")
