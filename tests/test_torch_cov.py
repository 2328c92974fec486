"""Port parity: one tree's K(x1, x2) and its VJP (K7F/K7B) and ``cov_fn``.

On the CPU the K7 wrappers run their plain versions (the torch interpreter
and its autograd VJP), so these tests hold those, at the shapes the
"pallas" covariance backend gives them (n != m, x1 != x2, a forecast
horizon m = 8, shared and per-particle points, and K(x, x) with x2 x1
itself), against the JAX package's plain reference ``eval_cov_impl`` and
its ``jax.vjp``, computed once per module and jitted.  No JAX Pallas kernel
runs.  The rules the CUDA kernels rest on are held here too: the heap
class (walking only a tree's class leaves K bitwise the same, and the
dropped slots have zero gradients), the folded cotangent of the symmetric
path (its VJP is JAX's VJP of the full asymmetric cotangent), and which
operands take the symmetric path.  ``cov_fn``'s dispatch is checked with
counters monkeypatched onto the wrappers.  Inputs are made with numpy from
a seed: P = 4 depth-3 heaps (two prior particles and two hand-built heaps
that together hold all eight node types).
"""

import jax
import numpy as np
import pytest
import torch
from _session_once import once_per_session

from nowcastautogp_tpu.models.config import GPConfig as JGPConfig
from nowcastautogp_tpu.models.structures import sample_particle
from nowcastautogp_tpu.ops import kernels as jkernels
from nowcastautogp_tpu_torch.models import structures as st
from nowcastautogp_tpu_torch.ops import cov, kernels, lml, megacov

torch.set_num_threads(1)

P = 4
# covariance and VJP tolerances of tests/test_pallas_megacov.py (n < 512)
COV_RTOL, COV_ATOL = 1e-5, 1e-5
COT_TOL = 2e-4

# (name, n, m, x1 per-particle?, x2 per-particle? or "x1": x2 is x1)
SHAPES = [
    ("forecast Ks: per-particle x, shared xs", 40, 8, True, False),
    ("shared x1, per-particle x2", 24, 56, False, True),
    ("forecast Kss: shared xs", 8, 8, False, False),
    ("fit K(x, x): per-particle x, x2 is x1", 24, 24, True, "x1"),
]
SYMMETRIC = SHAPES[-1][0]


@pytest.fixture(autouse=True)
def _restore_backends():
    """Every test starts and ends on the default backends."""
    saved = lml._LML_BACKEND, cov._COV_BACKEND
    yield
    lml._LML_BACKEND, cov._COV_BACKEND = saved


def _heaps(seed):
    rng = np.random.default_rng(seed)
    cfg = JGPConfig(max_depth=3)
    types = np.zeros((P, 7), np.int32)
    for i in range(P - 2):
        types[i] = sample_particle(rng, cfg)[0]
    types[P - 2] = (st.CP, st.PLUS, st.TIMES, st.GE, st.SE, st.PERIODIC,
                    st.LINEAR)
    types[P - 1, :3] = (st.TIMES, st.CONST, st.SE)
    params = rng.normal(0.0, 0.5, (P, 7, 3)).astype(np.float32)
    params[types == 0] = 0.0
    return types, params, rng


@pytest.fixture(scope="session")
def cases(tmp_path_factory):
    """Per shape: heaps, points, an asymmetric cotangent, and JAX's K and
    VJP of ``eval_cov_impl`` vmapped over particles.  The covariance is
    elementwise in (i, j), so every shape is the leading block of one
    (P, N1, N2) evaluation (points padded, cotangent zero outside the
    block, shared points broadcast): one compilation for all shapes, by
    one worker a session (``_session_once``)."""
    return once_per_session(tmp_path_factory, "torch_cov_cases", _cases)


def _cases():
    N1, N2 = (max(s[k] for s in SHAPES) for k in (1, 2))

    @jax.jit
    def cov_vjp(types, params, x1, x2, cot):
        f = jax.vmap(jkernels.eval_cov_impl)
        K, vjp = jax.vjp(lambda p: f(types, p, x1, x2), params)
        return K, vjp(cot)[0]

    out = {}
    for i, (name, n, m, per1, per2) in enumerate(SHAPES):
        types, params, rng = _heaps(seed=10 + i)
        x1 = np.sort(rng.uniform(0.0, 1.0, (P, n) if per1 else n), -1)
        x1 = x1.astype(np.float32)
        x2 = x1 if per2 == "x1" else np.sort(
            rng.uniform(0.5, 1.3, (P, m) if per2 else m), -1).astype(np.float32)
        cot = rng.standard_normal((P, n, m)).astype(np.float32)
        x1p = np.ones((P, N1), np.float32)
        x2p = np.ones((P, N2), np.float32)
        cotp = np.zeros((P, N1, N2), np.float32)
        x1p[:, :n], x2p[:, :m], cotp[:, :n, :m] = x1, x2, cot
        K, g = cov_vjp(types, params, x1p, x2p, cotp)
        out[name] = dict(types=types, params=params, x1=x1, x2=x2, cot=cot,
                         K=np.asarray(K)[:, :n, :m], g=np.asarray(g))
    return out


@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_plain_k7_matches_jax(cases, name):
    c = cases[name]
    t, p = torch.tensor(c["types"]), torch.tensor(c["params"])
    x1, x2 = torch.tensor(c["x1"]), torch.tensor(c["x2"])
    K = cov.cov_fwd(t, p, x1, x2)
    np.testing.assert_allclose(K.numpy(), c["K"], rtol=COV_RTOL,
                               atol=COV_ATOL * np.abs(c["K"]).max())
    dK = torch.tensor(c["cot"])
    g = cov.cov_bwd(t, p, x1, x2, dK)
    np.testing.assert_allclose(g.numpy(), c["g"], rtol=COT_TOL, atol=COT_TOL)
    # the autograd function's backward is the same VJP
    leaf = p.clone().requires_grad_(True)
    (cov.eval_cov_fused(t, leaf, x1, x2) * dK).sum().backward()
    torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)


def _chain_heap(top, N=63):
    """A valid tree whose highest live slot is ``top`` (the last slot of its
    level): operators down the right spine, a leaf beside each, cycling
    through every node type."""
    types = np.zeros(N, np.int32)
    ops, leaves = (st.PLUS, st.TIMES, st.CP), (st.SE, st.CONST, st.LINEAR,
                                                st.GE, st.PERIODIC)
    k, depth = 0, 0
    while k < top:
        types[k] = ops[depth % 3]
        types[2 * k + 1] = leaves[depth % 5]
        k, depth = 2 * k + 2, depth + 1
    types[k] = leaves[(depth + 2) % 5]
    return types


def test_heap_class_is_the_smallest_complete_heap():
    classes = (1, 3, 7, 15, 31, 63)
    types = np.stack([_chain_heap(c - 1) for c in classes]
                     + [np.zeros(63, np.int32)])        # an empty tree: 1
    got = cov.heap_class(torch.tensor(types)).tolist()
    assert got == list(classes) + [1]
    # the definition, slot by slot: every live slot lies below the class,
    # and the class is the smallest complete heap size with that property
    for row, c in zip(types, got):
        live = np.flatnonzero(row)
        assert (live < c).all() and (c == 1 or live.max() >= (c - 1) // 2)


@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_heap_class_truncation_is_exact(cases, name):
    """Walking only a tree's class gives the interpreter's K bit for bit,
    and JAX's VJP is zero in every slot past the class."""
    c = cases[name]
    t, p = torch.tensor(c["types"]), torch.tensor(c["params"])
    x1, x2 = (torch.tensor(c[k]).expand(P, c[k].shape[-1]) for k in ("x1", "x2"))
    for i, nc in enumerate(cov.heap_class(t).tolist()):
        one = slice(i, i + 1)   # one particle a call: same vector lanes
        K = kernels.eval_cov_batch(t[one], p[one], x1[one], x2[one])
        Kc = kernels.eval_cov_batch(t[one, :nc], p[one, :nc], x1[one],
                                    x2[one])
        assert torch.equal(Kc, K)
        assert not c["g"][i, nc:].any()


def test_truncation_at_depth_five():
    """The same at the fit's depth (31 slots), torch alone: K bitwise, and
    autograd's gradient zero past the class."""
    rng = np.random.default_rng(5)
    cfg = JGPConfig(max_depth=5)
    types = np.stack([sample_particle(rng, cfg)[0] for _ in range(6)]
                     + [_chain_heap(c - 1, 31) for c in (1, 3, 7, 15, 31)])
    t = torch.tensor(types)
    p = torch.tensor(rng.normal(0.0, 0.5, types.shape + (3,)),
                     dtype=torch.float32).requires_grad_(True)
    x = torch.linspace(0, 1, 12)
    K = kernels.eval_cov_batch(t, p, x, x)
    (g,) = torch.autograd.grad((K * torch.randn(K.shape)).sum(), p)
    cls = cov.heap_class(t).tolist()
    assert set(cls) == {1, 3, 7, 15, 31}
    with torch.no_grad():
        for i, nc in enumerate(cls):
            one = slice(i, i + 1)
            assert torch.equal(kernels.eval_cov_batch(t[one, :nc],
                                                      p[one, :nc], x, x),
                               kernels.eval_cov_batch(t[one], p[one], x, x))
            assert not g[i, nc:].any()


def test_folded_cotangent_gives_the_full_vjp(cases):
    """The symmetric path's fold: the VJP of K(x, x) with the lower
    triangular W (dK_ij + dK_ji below the diagonal, dK_ii on it) is JAX's
    VJP with the full asymmetric dK."""
    c = cases[SYMMETRIC]
    dK = torch.tensor(c["cot"])
    W = torch.tril(dK + dK.transpose(1, 2), -1) + torch.diag_embed(
        dK.diagonal(dim1=1, dim2=2))
    t, p, x = (torch.tensor(c[k]) for k in ("types", "params", "x1"))
    g = cov.cov_bwd(t, p, x, x, W)
    np.testing.assert_allclose(g.numpy(), c["g"], rtol=COT_TOL, atol=COT_TOL)
    # the fold matters: the lower triangle of dK alone is not the VJP
    unfolded = cov.cov_bwd(t, p, x, x, torch.tril(dK)).numpy()
    assert not np.allclose(unfolded, c["g"], rtol=COT_TOL, atol=COT_TOL)


def test_symmetric_path_rule():
    """The same tensor, or views of one buffer with the same shape and
    strides, take the symmetric path; equal values elsewhere do not."""
    buf = torch.linspace(0, 1, 16)
    assert cov._symmetric(buf, buf)
    assert cov._symmetric(buf.expand(P, 16), buf.expand(P, 16))
    per = torch.rand(P, 16)
    assert cov._symmetric(per, per[:])
    assert not cov._symmetric(buf, buf.clone())
    assert not cov._symmetric(buf, buf.expand(P, 16))       # other shape
    assert not cov._symmetric(per[:, :8], per[:, 8:])        # other offset
    assert not cov._symmetric(per, per.t().contiguous().t())  # other strides


def _counting(monkeypatch):
    calls = []
    for mod, name in ((cov, "cov_fwd"), (megacov, "megacov_fwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name:
                            calls.append(name) or fn(*a))
    return calls


@pytest.mark.parametrize("backend,n,m,symmetric,expect", [
    ("pallas", 40, 8, False, "cov_fwd"),
    ("pallas", 512, 512, False, "cov_fwd"),
    ("pallas", 520, 8, False, None),        # beyond K7: the interpreter
    ("pallas", 48, 48, True, "cov_fwd"),
    ("pallas", 544, 544, True, None),
    ("jnp", 40, 8, False, None),
    ("jnp", 48, 48, True, "megacov_fwd"),   # K(x, x) of a buffer: K4
    ("auto", 40, 8, False, None),           # "auto" is "jnp" on the CPU
    ("auto", 48, 48, True, "megacov_fwd"),
])
def test_cov_fn_dispatch(monkeypatch, backend, n, m, symmetric, expect):
    calls = _counting(monkeypatch)
    cov.set_cov_backend(backend)
    types, params, _ = _heaps(seed=1)
    t, p = torch.tensor(types[:2]), torch.tensor(params[:2])
    x1 = torch.linspace(0, 1, n)
    x2 = None if symmetric else torch.linspace(0.9, 1.1, m)
    K = cov.cov_fn(t, p, x1, x2)
    assert calls == ([expect] if expect else [])
    ref = kernels.eval_cov_batch(t, p, x1, x1 if symmetric else x2)
    torch.testing.assert_close(K, ref, rtol=0, atol=0)


def test_predictive_takes_three_covariances_from_k7(monkeypatch):
    calls = _counting(monkeypatch)
    cov.set_cov_backend("pallas")
    types, params, rng = _heaps(seed=2)
    n = 32
    x = torch.linspace(0, 1, n).expand(P, n)
    mask = (torch.arange(n) < 27).float().expand(P, n)
    y = torch.tensor(rng.standard_normal((P, n)).astype(np.float32))
    log_noise = torch.full((P,), -1.0)
    xs = torch.linspace(1.0, 1.2, 8)
    args = (torch.tensor(types), torch.tensor(params), log_noise, x, y, mask,
            xs)
    mu, covm = lml.gp_predict_batch(*args)
    assert calls == ["cov_fwd"] * 3
    cov.set_cov_backend("jnp")
    mu0, cov0 = lml.gp_predict_batch(*args)
    assert calls[3:] == ["megacov_fwd"]
    torch.testing.assert_close(mu, mu0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(covm, cov0, rtol=1e-5, atol=1e-5)


def test_shared_points_and_envelope():
    types, params, _ = _heaps(seed=3)
    t, p = torch.tensor(types), torch.tensor(params)
    x = torch.linspace(0, 1, 16)
    # a row-expanded view is taken as shared points
    assert cov._points(x.expand(P, 16))[1] == 0
    assert cov._points(x.expand(P, 16).contiguous())[1] == 16
    assert cov.fused_supported(512, 1) and not cov.fused_supported(513, 8)
    with pytest.raises(ValueError):
        cov.set_cov_backend("bogus")
    with pytest.raises(ValueError):
        cov.cov_fwd(t.to("meta"), p.to("meta"), x.to("meta"), x.to("meta"))
