"""Port parity: covariance interpreter, masked LML and predictive.

The same float32 inputs, made with numpy from a seed, go through the JAX
package's plain references (``eval_cov_batch``, ``gp_lml_batched(...,
backend="jnp")``, ``gp_predict_batch``, ``sampling_cholesky``) and through
the port on the CPU, where ``lml_core`` takes the plain version of the CUDA
kernels.  The JAX side is computed once per module.  Depth 3 heaps (7 slots),
P = 8 (six prior particles plus a hand-built Constant and a hand-built
SquaredExp heap, which the default leaf prior never draws), n = 32 with a
partial mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nowcastautogp_tpu.models.config import GPConfig as JGPConfig
from nowcastautogp_tpu.models.structures import sample_particle
from nowcastautogp_tpu.ops import kernels as jkernels
from nowcastautogp_tpu.ops import lml as jlml
from nowcastautogp_tpu_torch.models.structures import CONST, PLUS, SE
from nowcastautogp_tpu_torch.ops import kernels, lml, megalml
from _session_once import once_per_session

torch.set_num_threads(1)

P, N, n, N_ACTIVE, M = 8, 7, 32, 25, 4
COV_RTOL = 1e-5
VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
GRAD_RTOL, GRAD_ATOL = 3e-3, 3e-3
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cfg = JGPConfig(max_depth=3)
    ts, ps = zip(*[sample_particle(rng, cfg)[:2] for _ in range(P - 2)])
    types = np.zeros((P, N), np.int32)
    params = np.zeros((P, N, 3), np.float32)
    types[:P - 2], params[:P - 2] = np.stack(ts), np.stack(ps)
    # hand-built heaps: a lone Constant, and SE + Constant
    types[P - 2, 0] = CONST
    params[P - 2, 0, 0] = -0.3
    types[P - 1, :3] = (PLUS, SE, CONST)
    params[P - 1, 1, :2] = (-1.2, 0.4)
    params[P - 1, 2, 0] = -1.0
    return {
        "types": types,
        "params": params,
        "log_noise": rng.normal(-2.0, 0.3, P).astype(np.float32),
        "x": np.broadcast_to(np.linspace(0, 1, n, dtype=np.float32),
                             (P, n)).copy(),
        "y": rng.normal(0.0, 1.0, (P, n)).astype(np.float32),
        "mask": np.broadcast_to((np.arange(n) < N_ACTIVE).astype(np.float32),
                                (P, n)).copy(),
        "xs": np.linspace(1.0, 1.2, M, dtype=np.float32),
        "cot": rng.normal(0.0, 1.0, (P, n, n)).astype(np.float32),
    }


def _broken(d, lane=2):
    """Lane ``lane`` becomes a lone Constant of log-amplitude 100: K = inf
    in float32, the Cholesky fails, and the -1e10 guard must fire."""
    types, params = d["types"].copy(), d["params"].copy()
    types[lane] = 0
    types[lane, 0] = CONST
    params[lane] = 0.0
    params[lane, 0, 0] = 100.0
    return types, params


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="session")
def jax_ref(tmp_path_factory):
    """The JAX references, built once per session (``_session_once``)."""
    return once_per_session(tmp_path_factory, "torch_lml_jax",
                            lambda: _jax_ref(_inputs()))


def _jax_ref(data):
    d = {k: jnp.asarray(v) for k, v in data.items()}
    x1 = d["x"][0]

    def cov_obj(p):
        return jnp.sum(jkernels.eval_cov_batch(d["types"], p, x1, x1)
                       * d["cot"])

    def lml_sum(p, ln, y):
        return jnp.sum(jlml.gp_lml_batched(
            d["types"], p, ln, d["x"], y, d["mask"], backend="jnp"))

    lml_fn = jax.jit(lambda t, p: jlml.gp_lml_batched(
        t, p, d["log_noise"], d["x"], d["y"], d["mask"], backend="jnp"))
    bt, bp = _broken(data)
    mu, cov = jlml.gp_predict_batch(
        d["types"], d["params"], d["log_noise"], d["x"], d["y"], d["mask"],
        d["xs"], jlml.DEFAULT_JITTER, True)
    out = {
        "cov": jkernels.eval_cov_batch(d["types"], d["params"], x1, x1),
        "cov_grad": jax.jit(jax.grad(cov_obj))(d["params"]),
        "lml": lml_fn(d["types"], d["params"]),
        "lml_broken": lml_fn(jnp.asarray(bt), jnp.asarray(bp)),
        "grads": jax.jit(jax.grad(lml_sum, argnums=(0, 1, 2)))(
            d["params"], d["log_noise"], d["y"]),
        "mu": mu, "pred_cov": cov,
        "samp": jlml.sampling_cholesky(cov),
    }
    return jax.tree_util.tree_map(np.asarray, out)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _port_lml(data, **over):
    args = {k: _t(data[k]) for k in ("types", "params", "log_noise", "x",
                                     "y", "mask")}
    args.update(over)
    return lml.gp_lml_batched(args["types"], args["params"],
                              args["log_noise"], args["x"], args["y"],
                              args["mask"])


def test_cov_values_match_jax(data, jax_ref):
    K = kernels.eval_cov_batch(_t(data["types"]), _t(data["params"]),
                               _t(data["x"][0]), _t(data["x"][0]))
    ref = jax_ref["cov"]
    np.testing.assert_allclose(K.numpy(), ref, rtol=COV_RTOL,
                               atol=COV_RTOL * np.abs(ref).max())


def test_cov_param_grads_match_jax(data, jax_ref):
    p = _t(data["params"], requires_grad=True)
    x = _t(data["x"])  # per-particle x: exercises the batched-x path
    K = kernels.eval_cov_batch(_t(data["types"]), p, x, x)
    (K * _t(data["cot"])).sum().backward()
    ref = jax_ref["cov_grad"]
    np.testing.assert_allclose(p.grad.numpy(), ref, rtol=COV_RTOL,
                               atol=COV_RTOL * np.abs(ref).max())


def test_lml_value_matches_jax(data, jax_ref):
    got = _port_lml(data)
    np.testing.assert_allclose(got.numpy(), jax_ref["lml"], rtol=VAL_RTOL,
                               atol=VAL_ATOL)


@pytest.mark.parametrize("arg", ["params", "log_noise", "y"])
def test_lml_grads_match_jax(data, jax_ref, arg):
    leaf = _t(data[arg], requires_grad=True)
    _port_lml(data, **{arg: leaf}).sum().backward()
    ref = jax_ref["grads"][("params", "log_noise", "y").index(arg)]
    np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_non_spd_particle_gets_sentinel_and_is_isolated(data, jax_ref):
    bt, bp = _broken(data)
    got = _port_lml(data, types=_t(bt), params=_t(bp)).numpy()
    ref = jax_ref["lml_broken"]
    assert ref[2] <= -1e9, "construction must break the reference too"
    assert got[2] == -1e10
    keep = np.arange(P) != 2
    np.testing.assert_allclose(got[keep], ref[keep], rtol=VAL_RTOL,
                               atol=VAL_ATOL)
    np.testing.assert_array_equal(got[keep], _port_lml(data).numpy()[keep])


def test_predict_matches_jax(data, jax_ref):
    mu, cov = lml.gp_predict_batch(
        *(_t(data[k]) for k in ("types", "params", "log_noise", "x", "y",
                                "mask", "xs")))
    np.testing.assert_allclose(mu.numpy(), jax_ref["mu"], rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(cov.numpy(), jax_ref["pred_cov"],
                               rtol=PRED_RTOL, atol=PRED_ATOL)


def test_sampling_cholesky_matches_jax(jax_ref):
    # eigenvector signs are arbitrary: compare the factor's product
    A = lml.sampling_cholesky(_t(jax_ref["pred_cov"])).numpy()
    B = jax_ref["samp"]
    np.testing.assert_allclose(A @ A.transpose(0, 2, 1),
                               B @ B.transpose(0, 2, 1), rtol=PRED_RTOL,
                               atol=PRED_ATOL)


def test_lml_core_dispatch(data):
    args = [_t(data[k]) for k in ("types", "params")]
    mask = _t(data["mask"])
    diagv = mask * 0.2 + (1 - mask)
    rest = [diagv, mask, _t(data["x"]), _t(data["y"]) * mask]
    # CPU tensors take the plain version
    torch.testing.assert_close(megalml.lml_core(*args, *rest),
                               megalml.lml_core_plain(*args, *rest),
                               rtol=0, atol=0)
    # the kernel wrappers take CUDA tensors only, and no other device has
    # an LML core
    with pytest.raises(ValueError):
        megalml.megalml_val(*args, *rest)
    with pytest.raises(ValueError):
        megalml.megalml_vag(*args, *rest)
    meta = [t.to("meta") for t in args + rest]
    with pytest.raises(ValueError):
        megalml.lml_core(*meta)


@pytest.mark.parametrize("n_nodes,n_pts,ok", [
    (31, 160, True), (63, 512, True), (7, 32, True),
    (127, 160, False), (31, 544, False), (31, 72, False), (31, 16, False),
])
def test_kernel_envelope(n_nodes, n_pts, ok):
    assert megalml.megalml_supported(n_nodes, n_pts) is ok
