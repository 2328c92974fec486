"""Port parity: the blocked Cholesky core of the "pallas" LML backend (K6a/K6b).

On the CPU the K6 wrappers run their plain versions, so these tests hold
those and the "pallas" LML glue against the JAX package's plain references,
computed once per module and jitted: ``jnp.linalg.cholesky``/``cho_solve``
for (L, alpha), ``cho_solve`` against I for K^-1, and
``gp_lml_batched(backend="jnp")`` with its gradients for the whole masked
LML.  No JAX Pallas kernel runs.  Inputs are made with numpy from a seed:
P = 4 depth-3 heaps (three prior particles and a hand-built CP heap), n in
{32, 64} with partial masks.  The log-noise is drawn around -1: at -2 some
n = 64 matrices are conditioned badly enough that the float32 parameter
gradients of JAX and of the port alike miss 3e-3 against float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nowcastautogp_tpu.models.config import GPConfig as JGPConfig
from nowcastautogp_tpu.models.structures import sample_particle
from nowcastautogp_tpu.ops import lml as jlml
from nowcastautogp_tpu_torch.models import structures as st
from nowcastautogp_tpu_torch.ops import chol, cov, lml
from _session_once import once_per_session

torch.set_num_threads(1)

P = 4
# (L, alpha) and K^-1 of the same float32 K; the LML as tests/test_torch_lml.py
FACTOR_TOL = 1e-4
VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
GRAD_RTOL, GRAD_ATOL = 3e-3, 3e-3


@pytest.fixture(autouse=True)
def _restore_backends():
    """Every test starts and ends on the default backends."""
    saved = lml._LML_BACKEND, cov._COV_BACKEND
    yield
    lml._LML_BACKEND, cov._COV_BACKEND = saved


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    cfg = JGPConfig(max_depth=3)
    types = np.zeros((P, 7), np.int32)
    params = np.zeros((P, 7, 3), np.float32)
    for i in range(P - 1):
        types[i], params[i] = sample_particle(rng, cfg)[:2]
    types[P - 1, :3] = (st.CP, st.SE, st.PERIODIC)
    params[P - 1, :3] = rng.normal(0.0, 0.5, (3, 3))
    x = np.broadcast_to(np.linspace(0, 1, n, dtype=np.float32), (P, n)).copy()
    mask = np.broadcast_to((np.arange(n) < n - 7).astype(np.float32),
                           (P, n)).copy()
    return {
        "types": types, "params": params,
        "log_noise": rng.normal(-1.0, 0.3, P).astype(np.float32),
        "x": x, "mask": mask,
        "y": (np.sin(6 * x) + 0.1 * rng.standard_normal((P, n))).astype(
            np.float32),
    }


@pytest.fixture(scope="session")
def cases(tmp_path_factory):
    """Per n: inputs, the masked A and ym, JAX's (L, alpha), K^-1, and
    ``gp_lml_batched(backend="jnp")`` with its gradients; built once per
    session (``_session_once``)."""
    return once_per_session(tmp_path_factory, "torch_chol_cases",
                            _cases)


def _cases():

    @jax.jit
    def factor(A, ym):
        L = jnp.linalg.cholesky(A)
        alpha = jax.vmap(lambda L, b: jax.scipy.linalg.cho_solve((L, True), b))(
            L, ym)
        eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
        Kinv = jax.vmap(lambda L, b: jax.scipy.linalg.cho_solve((L, True), b))(
            L, eye)
        return L, alpha, Kinv

    @jax.jit
    def lml_vjp(t, p, ln, x, y, mask):
        val, vjp = jax.vjp(lambda p, ln, y: jlml.gp_lml_batched(
            t, p, ln, x, y, mask, backend="jnp"), p, ln, y)
        return (val, *vjp(jnp.ones(P, jnp.float32)))

    out = {}
    for n in (32, 64):
        d = _inputs(n, seed=n)
        A = lml.masked_kernel_matrix(
            *(torch.tensor(d[k]) for k in ("types", "params", "log_noise",
                                           "x", "mask"))).numpy()
        ym = d["y"] * d["mask"]
        L, alpha, Kinv = factor(A, ym)
        val, gp, gn, gy = lml_vjp(*(d[k] for k in ("types", "params",
                                                   "log_noise", "x", "y",
                                                   "mask")))
        out[n] = dict(d, A=A, ym=ym, L=np.asarray(L),
                      alpha=np.asarray(alpha), Kinv=np.asarray(Kinv),
                      val=np.asarray(val),
                      grads=tuple(np.asarray(g) for g in (gp, gn, gy)))
    return out


@pytest.mark.parametrize("n", [32, 64])
def test_plain_k6_matches_jax_factor_and_inverse(cases, n):
    c = cases[n]
    L, alpha = chol.chol_solve_batched(torch.tensor(c["A"]),
                                       torch.tensor(c["ym"]))
    assert torch.equal(L, torch.tril(L))
    np.testing.assert_allclose(L.numpy(), c["L"], rtol=FACTOR_TOL,
                               atol=FACTOR_TOL)
    np.testing.assert_allclose(alpha.numpy(), c["alpha"], rtol=FACTOR_TOL,
                               atol=FACTOR_TOL * np.abs(c["alpha"]).max())
    # masked rows factor to identity rows
    np.testing.assert_array_equal(L[:, n - 7:, n - 7:].numpy(),
                                  np.broadcast_to(np.eye(7), (P, 7, 7)))
    Kinv = chol.chol_inverse_batched(L)
    scale = np.abs(c["Kinv"]).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(Kinv.numpy() / scale, c["Kinv"] / scale,
                               rtol=FACTOR_TOL, atol=FACTOR_TOL)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("cov_backend", ["pallas", "jnp"])
def test_pallas_lml_backend_matches_jax(cases, n, cov_backend):
    """The "pallas" LML (K(x, x) from K7 or K4, then K6a/K6b) against the
    JAX package's interpreter LML, value and all three gradients."""
    c = cases[n]
    lml.set_lml_backend("pallas")
    cov.set_cov_backend(cov_backend)
    leaves = [torch.tensor(c[k], requires_grad=True)
              for k in ("params", "log_noise", "y")]
    out = lml.gp_lml_batched(torch.tensor(c["types"]), leaves[0], leaves[1],
                             torch.tensor(c["x"]), leaves[2],
                             torch.tensor(c["mask"]))
    np.testing.assert_allclose(out.detach().numpy(), c["val"], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    out.sum().backward()
    for leaf, ref in zip(leaves, c["grads"]):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_pallas_backend_runs_k6a_then_k6b(cases, monkeypatch):
    """Value calls factor through K6a only; a gradient adds one K6b, and both
    give the same value (the consistency contract)."""
    c = cases[32]
    calls = []
    for name in ("chol_solve_batched", "tri_inverse"):
        fn = getattr(chol, name)
        monkeypatch.setattr(chol, name, lambda *a, fn=fn, name=name:
                            calls.append(name) or fn(*a))
    lml.set_lml_backend("pallas")
    args = [torch.tensor(c[k]) for k in ("types", "params", "log_noise", "x",
                                         "y", "mask")]
    with torch.no_grad():
        val = lml.gp_lml_batched(*args)
    assert calls == ["chol_solve_batched"]
    p = args[1].clone().requires_grad_(True)
    out = lml.gp_lml_batched(args[0], p, *args[2:])
    out.sum().backward()
    assert calls[1:] == ["chol_solve_batched", "tri_inverse"]
    torch.testing.assert_close(out.detach(), val, rtol=0, atol=0)


def test_non_spd_lane_is_rejected_alone(cases):
    c = cases[32]
    A = torch.tensor(c["A"])
    ym = torch.tensor(c["ym"])
    bad = A.clone()
    bad[1, 5, 5] = -1.0
    L, alpha = chol.chol_solve_batched(bad, ym)
    assert torch.isnan(L[1]).any() and torch.isnan(alpha[1]).any()
    keep = torch.arange(P) != 1
    L0, alpha0 = chol.chol_solve_batched(A, ym)
    assert torch.equal(L[keep], L0[keep]) and torch.equal(alpha[keep],
                                                          alpha0[keep])
    core = chol.lml_core(bad, ym)
    assert torch.isnan(core[1]) and torch.isfinite(core[keep]).all()


def test_envelope_and_backend_names():
    A = torch.eye(40).expand(2, 40, 40)
    with pytest.raises(ValueError, match="multiple of 32"):
        chol.chol_solve_batched(A, torch.zeros(2, 40))
    with pytest.raises(ValueError, match="multiple of 32"):
        chol.tri_inverse(A)
    with pytest.raises(NotImplementedError, match="2048"):
        chol.tri_inverse(torch.eye(2080).expand(1, 2080, 2080))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lml.set_lml_backend("jnp")
    with pytest.raises(ValueError):
        lml.set_lml_backend("bogus")
    assert lml._LML_BACKEND == "auto"
