"""Port parity: the composed LML path (K4/K5 covariance, K3 inverse core).

On the CPU every wrapper runs its kernel's plain version, so these tests
hold the plain versions and the glue around them against the JAX package's
plain references, computed once per session (``_session_once``):
``kernels.eval_cov_batch`` and
its ``jax.vjp``, ``lml._lml_core_inv`` (the analytic-VJP inverse core with
XLA's Cholesky) and ``gp_lml_batched(backend="jnp")``.  No JAX Pallas
kernel runs.  Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _session_once import once_per_session

from nowcastautogp_tpu.models.config import GPConfig as JGPConfig
from nowcastautogp_tpu.models.structures import sample_particle
from nowcastautogp_tpu.ops import kernels as jkernels
from nowcastautogp_tpu.ops import lml as jlml
from nowcastautogp_tpu_torch.models import structures as st
from nowcastautogp_tpu_torch.ops import chol_mxu, lml, megacov

torch.set_num_threads(1)

# covariance VJP tolerances of tests/test_pallas_megacov.py, by n
COT_TOL = {64: 2e-4, 520: 2e-3}
VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
GRAD_RTOL, GRAD_ATOL = 3e-3, 3e-3
# composed LML against gp_lml_batched(backend="jnp")
LML_VAL_RTOL, LML_GRAD_TOL = 1e-5, 2e-3
N_COMPOSED = 544


def _particles(P, depth, seed, hand=()):
    """Prior particles, then the hand-built heaps ``hand`` (slot -> type)."""
    rng = np.random.default_rng(seed)
    cfg = JGPConfig(max_depth=depth)
    N = 2**depth - 1
    types = np.zeros((P, N), np.int32)
    params = rng.normal(0.0, 0.5, (P, N, 3)).astype(np.float32)
    for i in range(P - len(hand)):
        types[i], params[i] = sample_particle(rng, cfg)[:2]
    for i, tree in enumerate(hand, start=P - len(hand)):
        for slot, t in tree.items():
            types[i, slot] = t
    params[types == 0] = 0.0
    return types, params


_HAND = (
    {0: st.CP, 1: st.TIMES, 2: st.PLUS, 3: st.SE, 4: st.PERIODIC,
     5: st.LINEAR, 6: st.GE},
    {0: st.PLUS, 1: st.GE, 2: st.CONST},
)


def _masked_A(types, params, n, n_active, seed):
    """SPD A = K o (m m^T) + diag (K from the port's interpreter) and a
    masked target, as numpy arrays."""
    rng = np.random.default_rng(seed)
    P = types.shape[0]
    x = np.linspace(0, 1, n, dtype=np.float32)
    K = megacov.megacov_fwd_plain(torch.tensor(types), torch.tensor(params),
                                  torch.tensor(x).expand(P, n)).numpy()
    m = (np.arange(n) < n_active).astype(np.float32)
    diag = m * np.exp(rng.normal(-2.0, 0.3, (P, 1))).astype(np.float32) + 1 - m
    A = K * (m[:, None] * m[None, :]) + diag[:, :, None] * np.eye(n)
    ym = (np.sin(6 * x) + 0.1 * rng.standard_normal((P, n))) * m
    return A.astype(np.float32), ym.astype(np.float32)


@pytest.fixture(scope="session")
def cov_cases(tmp_path_factory):
    """(a): heaps, x, an asymmetric cotangent and the JAX interpreter's
    covariance and full VJP, at n = 64 (P = 4, depth 4) and n = 520
    (P = 2, depth 3)."""
    return once_per_session(tmp_path_factory, "megacov_cov_cases",
                            _cov_cases)


def _cov_cases():
    @jax.jit
    def cov_vjp(types, params, x, cot):
        K, vjp = jax.vjp(lambda p: jkernels.eval_cov_batch(types, p, x, x),
                         params)
        return K, vjp(cot)[0]

    out = {}
    for n, P, depth in ((64, 4, 4), (520, 2, 3)):
        types, params = _particles(P, depth, seed=n, hand=_HAND[:1])
        rng = np.random.default_rng(n + 1)
        x = np.linspace(0, 1, n, dtype=np.float32)
        cot = rng.standard_normal((P, n, n)).astype(np.float32)
        K, g = cov_vjp(types, params, x, cot)
        out[n] = dict(types=types, params=params, x=x, cot=cot,
                      K=np.asarray(K), g=np.asarray(g))
    return out


@pytest.mark.parametrize("n", [64, 520])
def test_plain_k4_k5_match_jax_vjp(cov_cases, n):
    c = cov_cases[n]
    P = c["types"].shape[0]
    t, p = torch.tensor(c["types"]), torch.tensor(c["params"])
    x = torch.tensor(c["x"]).expand(P, n).contiguous()
    K = megacov.megacov_fwd(t, p, x)
    np.testing.assert_allclose(K.numpy(), c["K"], rtol=1e-5, atol=1e-5)
    # the fold is what makes the lower-triangle VJP right for an
    # asymmetric cotangent
    dK = torch.tensor(c["cot"])
    assert not torch.equal(dK, dK.transpose(1, 2))
    g = megacov.megacov_bwd(t, p, x, dK)
    tol = COT_TOL[n]
    np.testing.assert_allclose(g.numpy(), c["g"], rtol=tol, atol=tol)
    # CovFn's backward is the same VJP
    leaf = p.clone().requires_grad_(True)
    (megacov.cov_batched(t, leaf, x) * dK).sum().backward()
    torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)


@pytest.fixture(scope="session")
def inv_cases(tmp_path_factory):
    """(b): masked SPD A and ym, a cotangent, and ``_lml_core_inv``'s
    value and VJP, at n in {64, 96} (K3's envelope) and n = 72 (outside it:
    the inverse core's cholesky + triangular-solve form)."""
    return once_per_session(tmp_path_factory, "megacov_inv_cases",
                            _inv_cases)


def _inv_cases():
    @jax.jit
    def core_vjp(A, ym, c):
        val, vjp = jax.vjp(jlml._lml_core_inv, A, ym)
        return (val, *vjp(c))

    out = {}
    for n in (64, 72, 96):
        types, params = _particles(4, 4, seed=n + 5, hand=_HAND[1:])
        A, ym = _masked_A(types, params, n, n - 13, seed=n)
        c = np.random.default_rng(n + 2).normal(1.0, 0.3, 4).astype(np.float32)
        val, dA, dym = core_vjp(A, ym, c)
        out[n] = dict(A=A, ym=ym, c=c, val=np.asarray(val), dA=np.asarray(dA),
                      dym=np.asarray(dym))
    return out


@pytest.mark.parametrize("n", [64, 72, 96])
def test_inv_core_matches_jax(inv_cases, n):
    c = inv_cases[n]
    A = torch.tensor(c["A"], requires_grad=True)
    ym = torch.tensor(c["ym"], requires_grad=True)
    val = lml.InvCoreFn.apply(A, ym)
    np.testing.assert_allclose(val.detach().numpy(), c["val"], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    val.backward(torch.tensor(c["c"]))
    np.testing.assert_allclose(A.grad.numpy(), c["dA"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(ym.grad.numpy(), c["dym"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_plain_k3_is_the_inverse_factor(inv_cases):
    A = torch.tensor(inv_cases[96]["A"])
    X = chol_mxu.tri_inv(A)
    assert torch.equal(X, torch.tril(X))
    L = torch.linalg.cholesky(A.double())
    eye = torch.eye(96, dtype=torch.float64).expand_as(L)
    torch.testing.assert_close(X.double() @ L, eye, rtol=0, atol=1e-4)
    # a non-SPD lane is NaN in its own lane only
    bad = A.clone()
    bad[1, 5, 5] = -1.0
    Xb = chol_mxu.tri_inv(bad)
    assert torch.isnan(Xb[1]).any()
    keep = torch.arange(4) != 1
    assert torch.equal(Xb[keep], X[keep])


@pytest.fixture(scope="module")
def composed_case():
    """(c): P = 3 depth-3 particles at n = 544 with a partial mask, and the
    JAX package's interpreter LML (backend "jnp") with its gradients."""
    n = N_COMPOSED
    types, params = _particles(3, 3, seed=44, hand=({0: st.TIMES, 1: st.SE,
                                                     2: st.PERIODIC},))
    rng = np.random.default_rng(45)
    x = np.broadcast_to(np.linspace(0, 1, n, dtype=np.float32), (3, n)).copy()
    y = (np.sin(6 * x) + 0.1 * rng.standard_normal((3, n))).astype(np.float32)
    mask = np.broadcast_to((np.arange(n) < 530).astype(np.float32),
                           (3, n)).copy()
    log_noise = rng.normal(-2.0, 0.3, 3).astype(np.float32)
    d = dict(types=types, params=params, log_noise=log_noise, x=x, y=y,
             mask=mask)

    @jax.jit
    def lml_vjp(p, ln):
        val, vjp = jax.vjp(lambda p, ln: jlml.gp_lml_batched(
            types, p, ln, x, y, mask, backend="jnp"), p, ln)
        return (val, *vjp(jnp.ones(3, jnp.float32)))

    val, gp, gn = lml_vjp(params, log_noise)
    return d, np.asarray(val), np.asarray(gp), np.asarray(gn)


def test_composed_lml_matches_jax(composed_case, monkeypatch):
    d, val, gp, gn = composed_case
    calls = []
    composed = lml.lml_core_composed
    monkeypatch.setattr(lml, "lml_core_composed",
                        lambda *a: calls.append(1) or composed(*a))
    p = torch.tensor(d["params"], requires_grad=True)
    ln = torch.tensor(d["log_noise"], requires_grad=True)
    out = lml.gp_lml_batched(torch.tensor(d["types"]), p, ln,
                             torch.tensor(d["x"]), torch.tensor(d["y"]),
                             torch.tensor(d["mask"]))
    assert calls, "n = 544 must take the composed core"
    # the summed value as tests/test_pallas_megacov.py holds it, and each
    # particle at the port's LML value tolerance
    np.testing.assert_allclose(float(out.detach().sum()), float(val.sum()),
                               rtol=LML_VAL_RTOL)
    np.testing.assert_allclose(out.detach().numpy(), val, rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    out.sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), gp, rtol=LML_GRAD_TOL,
                               atol=LML_GRAD_TOL)
    np.testing.assert_allclose(ln.grad.numpy(), gn, rtol=LML_GRAD_TOL,
                               atol=LML_GRAD_TOL)


def test_masked_kernel_matrix_takes_the_covariance_kernel_path(monkeypatch):
    types, params = _particles(2, 3, seed=3)
    calls = []
    fwd = megacov.megacov_fwd
    monkeypatch.setattr(megacov, "megacov_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    x = torch.linspace(0, 1, 40)
    mask = (torch.arange(40) < 33).float()
    A = lml.masked_kernel_matrix(torch.tensor(types), torch.tensor(params),
                                 torch.tensor([-2.0, -1.5]), x, mask)
    assert calls == [1]
    K = megacov.megacov_fwd_plain(torch.tensor(types), torch.tensor(params),
                                  x.expand(2, 40))
    torch.testing.assert_close(A[:, :33, :33],
                               K[:, :33, :33] + torch.diag_embed(
                                   torch.exp(torch.tensor([-2.0, -1.5]))[:, None]
                                   .expand(2, 33) + 1e-5), rtol=0, atol=0)
    torch.testing.assert_close(A[:, 33:, 33:], torch.eye(7).expand(2, 7, 7),
                               rtol=0, atol=0)


def test_lml_beyond_the_envelope_raises(monkeypatch):
    """Beyond 2048 the composed core runs in particle chunks under the byte
    budget; a particle that alone exceeds the budget raises, with the
    sizes, before any work."""
    P, n = 2, 2080
    z = torch.zeros(P, n)
    monkeypatch.setattr(lml, "_CHUNK_BYTES", lml._ROW_MATRICES * n * n * 4 - 1)
    with pytest.raises(ValueError, match="n=2080 needs .* GiB budget"):
        lml.lml_core(torch.zeros(P, 7, dtype=torch.int32), torch.zeros(P, 7, 3),
                     z + 1, z + 1, z, z)


@pytest.mark.parametrize("n_nodes,n_pts,cov_ok,inv_ok", [
    (31, 576, True, True), (63, 2048, True, False), (7, 8, True, False),
    (31, 1024, True, True), (127, 576, False, True), (31, 2056, True, False),
    (31, 100, False, False), (31, 1056, True, False), (31, 4096, True, False),
    (31, 4104, False, False),
])
def test_kernel_envelopes(n_nodes, n_pts, cov_ok, inv_ok):
    assert megacov.megacov_supported(n_nodes, n_pts) is cov_ok
    assert chol_mxu.mxu_supported(n_pts) is inv_ok


def _lone_constant(n=544, n_active=530, seed=0):
    """Particle 0 of ``tests/test_torch_cuda.py::_batch(n=544, n_active=530,
    seed=0)``: a lone Constant, whose covariance is rank one, at P = 1.  The
    draws are made in that batch's order and shapes (9 particles, 31 slots)
    and then sliced to particle 0 and its one live slot: a tree's
    covariance and gradients do not depend on its empty slots, and the
    plain interpreter would evaluate all five levels of them."""
    rng = np.random.default_rng(seed)
    P = 9
    params = rng.normal(0.0, 0.5, (P, 31, 3)).astype(np.float32)[:1, :1]
    types = np.full((1, 1), st.CONST, np.int32)
    mask = (np.arange(n) < n_active).astype(np.float32)[None]
    diagv = mask * (np.exp(rng.normal(-2.0, 0.3, (P, 1)))[:1] + 1e-5) + 1 - mask
    x = np.linspace(0, 1, n)[None]
    ym = rng.normal(0.0, 1.0, (P, n))[:1] * mask
    return types, params, diagv, mask, x, ym


def test_composed_core_cotangent_keeps_float64_digits():
    """On a rank-one covariance alpha alpha^T - A^-1 cancels to a small
    matrix; formed in float32 the parameter gradient misses float64 by 3.9x
    the gradient tolerance.  The core forms it in float64 and rounds once."""
    types, *rest = _lone_constant()
    grads = {}
    for dtype in (torch.float32, torch.float64):
        params, diagv, mask, x, ym = (torch.tensor(a, dtype=dtype)
                                      for a in rest)
        p = params.requires_grad_(True)
        lml.lml_core_composed(torch.tensor(types), p, diagv, mask, x,
                              ym).sum().backward()
        grads[dtype] = p.grad.double()
    g32, g64 = grads[torch.float32], grads[torch.float64]
    ratio = ((g32 - g64).abs() / (GRAD_ATOL + GRAD_RTOL * g64.abs())).max()
    assert float(ratio) <= 1.0, float(ratio)
