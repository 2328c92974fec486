"""Port parity: the LML and the predictive beyond 2,048 points.

Past 2048 the JAX package's dispatch runs its interpreter covariance and an
XLA Cholesky (``gp_lml_batched(backend="jnp")``); the port runs the
composed core (K4 -> the "inv" form -> K5 on the card, their plain
versions here) in particle chunks under a byte budget.  At P = 2 depth-3
particles (7 slots) and n = 2,080 with a partial mask:

* the value and the parameter and noise gradients match JAX's at the
  composed-core tolerances of ``test_torch_megacov.py``;
* chunked one particle a call, the value equals the unchunked call's to
  float32 rounding and the gradients at the composed-core tolerance: not
  bitwise on the CPU, since torch's batched matrix-vector product
  ``A^-1 ym`` sums in an order that depends on the batch size, and the
  gradient's sum over n^2 terms of ``alpha alpha^T`` magnifies that
  rounding (5e-4 relative here);
* ``gp_predict_batch`` there matches JAX's at the predictive tolerances of
  ``test_torch_lml.py``.

The JAX side is jitted and computed once per session, and so is the
port's unchunked value and gradient, which two tests hold.  The port's
plain interpreter takes seconds a call at this n, so the module runs
torch on 4 threads and restores the suite's 1 after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _session_once import once_per_session

from nowcastautogp_tpu.ops import lml as jlml
from nowcastautogp_tpu_torch.models import structures as st
from nowcastautogp_tpu_torch.ops import lml

P, N_PTS, N_ACTIVE, M = 2, 2080, 2070, 4
VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
LML_GRAD_TOL = 2e-3
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4
CHUNK_VAL_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _four_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def _inputs():
    """Two depth-3 heaps (a sum with a periodic leaf, a product), a partial
    mask, per-particle noise; numpy."""
    rng = np.random.default_rng(7)
    types = np.zeros((P, 7), np.int32)
    for i, tree in enumerate(({0: st.PLUS, 1: st.SE, 2: st.PERIODIC},
                              {0: st.TIMES, 1: st.LINEAR, 2: st.GE})):
        for slot, t in tree.items():
            types[i, slot] = t
    params = rng.normal(0.0, 0.4, (P, 7, 3)).astype(np.float32)
    params[types == 0] = 0.0
    x = np.broadcast_to(np.linspace(0, 1, N_PTS, dtype=np.float32),
                        (P, N_PTS)).copy()
    y = (np.sin(6 * x) + 0.1 * rng.standard_normal((P, N_PTS))).astype(
        np.float32)
    mask = np.broadcast_to((np.arange(N_PTS) < N_ACTIVE).astype(np.float32),
                           (P, N_PTS)).copy()
    log_noise = rng.normal(-2.0, 0.3, P).astype(np.float32)
    xs = np.linspace(1.0, 1.02, M, dtype=np.float32)
    return dict(types=types, params=params, log_noise=log_noise, x=x, y=y,
                mask=mask, xs=xs)


def _jax_refs():
    d = _inputs()

    @jax.jit
    def lml_vjp(p, ln):
        val, vjp = jax.vjp(lambda p, ln: jlml.gp_lml_batched(
            d["types"], p, ln, d["x"], d["y"], d["mask"], backend="jnp"),
            p, ln)
        return (val, *vjp(jnp.ones(P, jnp.float32)))

    val, gp, gn = lml_vjp(d["params"], d["log_noise"])
    mu, cov = jlml.gp_predict_batch(
        d["types"], d["params"], d["log_noise"], d["x"], d["y"], d["mask"],
        d["xs"], jlml.DEFAULT_JITTER, True)
    return d, tuple(np.asarray(a) for a in (val, gp, gn, mu, cov))


@pytest.fixture(scope="session")
def refs(tmp_path_factory):
    return once_per_session(tmp_path_factory, "large_n_jax_refs", _jax_refs)


def _port_lml(d):
    p = torch.tensor(d["params"], requires_grad=True)
    ln = torch.tensor(d["log_noise"], requires_grad=True)
    out = lml.gp_lml_batched(torch.tensor(d["types"]), p, ln,
                             torch.tensor(d["x"]), torch.tensor(d["y"]),
                             torch.tensor(d["mask"]))
    out.sum().backward()
    return out.detach(), p.grad, ln.grad


def _port_whole(d):
    """The unchunked port call, with the composed core's calls counted."""
    calls = []
    composed = lml.lml_core_composed
    lml.lml_core_composed = (lambda *a: calls.append(a[0].shape[0])
                             or composed(*a))
    try:
        return _port_lml(d), calls
    finally:
        lml.lml_core_composed = composed


@pytest.fixture(scope="module")
def whole(refs, tmp_path_factory):
    return once_per_session(tmp_path_factory, "large_n_port_whole",
                            lambda: _port_whole(refs[0]))


def test_lml_beyond_2048_matches_jax(refs, whole):
    _, (val, gp, gn, _, _) = refs
    (out, g_p, g_n), calls = whole
    assert calls == [P], "n = 2080 takes one composed call of both particles"
    np.testing.assert_allclose(out.numpy(), val, rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    np.testing.assert_allclose(g_p.numpy(), gp, rtol=LML_GRAD_TOL,
                               atol=LML_GRAD_TOL)
    np.testing.assert_allclose(g_n.numpy(), gn, rtol=LML_GRAD_TOL,
                               atol=LML_GRAD_TOL)


def test_particle_chunks_give_the_unchunked_result(refs, whole, monkeypatch):
    d, _ = refs
    whole = whole[0]
    monkeypatch.setattr(lml, "_CHUNK_BYTES",
                        lml._ROW_MATRICES * N_PTS * N_PTS * 4)
    assert lml.composed_chunk(N_PTS) == 1
    calls = []
    composed = lml.lml_core_composed
    monkeypatch.setattr(lml, "lml_core_composed",
                        lambda *a: calls.append(a[0].shape[0])
                        or composed(*a))
    chunked = _port_lml(d)
    # one call a chunk, and each checkpointed chunk again in the backward
    assert calls == [1] * (2 * P)
    torch.testing.assert_close(chunked[0], whole[0], rtol=CHUNK_VAL_RTOL,
                               atol=0.0)
    for a, b in zip(whole[1:], chunked[1:]):
        torch.testing.assert_close(b, a, rtol=LML_GRAD_TOL, atol=LML_GRAD_TOL)


def test_predictive_beyond_2048_matches_jax(refs):
    d, (_, _, _, mu, cov) = refs
    with torch.no_grad():
        got_mu, got_cov = lml.gp_predict_batch(
            torch.tensor(d["types"]), torch.tensor(d["params"]),
            torch.tensor(d["log_noise"]), torch.tensor(d["x"]),
            torch.tensor(d["y"]), torch.tensor(d["mask"]),
            torch.tensor(d["xs"]))
    np.testing.assert_allclose(got_mu.numpy(), mu, rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(got_cov.numpy(), cov, rtol=PRED_RTOL,
                               atol=PRED_ATOL)
