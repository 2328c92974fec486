"""Port parity: the refresh branches of ``forecast_with_nowcasts``.

Both packages start from one JAX state -- P = 8 depth-3 particles
reweighted on 24 weeks (capacity 32), the state of
``tests/test_torch_forecast_hmc.py`` -- carried across by
``from_jax_state``, with S = 3 nowcast scenarios of the next two weeks and a
3-week forecast, on the default LML route (the plain version of K1/K2 here).

Held exactly against JAX on the same state:

* the batched branch's reweight: each row's old and new LML and the delta
  it gives (rtol 1e-4, atol 1e-3), and ``-1e10`` where either LML is at the
  sentinel (a particle with NaN parameters end to end, and the guard on
  each side);
* the per-scenario ESS resample: the row indices and weights from one
  numpy seed, bitwise;
* the per-draw-HMC scan: every draw refreshes all S x P rows with
  ``n_steps = forecast_n_hmc`` from the state the last one left, and each
  draw's predictive equals JAX's ``gp_predict_batch`` at the refreshed
  hyperparameters on JAX's own scenario rows (rtol 1e-3, atol 1e-4, the
  tolerance of ``tests/test_torch_forecast_hmc.py``).

The generators differ (threefry against torch), so the draws are held in
distribution: per scenario and date, the 5/50/95% quantiles within a share
of the JAX draws' 90% spread (q95 - q05).  The JAX sampler's own spread
was measured first, from this state over 16 ``draw_seed`` blocks (120
pairs; the largest pairwise gap, as a share of the spread, at the 5%, 50%
and 95% quantiles): serial 0.287, 0.126, 0.224, ``n_hmc`` 0.265, 0.139,
0.235 and ``n_mcmc=1, n_hmc=1`` 0.699, 0.340, 0.438 (a structure move on 8
particles moves more than HMC alone) at 200 draws a scenario;
``forecast_n_hmc=1`` 0.886, 0.562, 0.708 at 24 draws (its draws follow
successive refreshes and are correlated; at 48 draws 0.843, 0.427, 0.595,
for twice the time on both sides).  The tolerances are those gaps rounded
up to the next 0.05.

Scenario chunks: with the chunk budget forced down to one scenario a call,
the batched branch runs once per scenario and keeps the contract, and its
draws agree with the one-call draws within the ``n_hmc`` shares.

Contracts, on the port alone: the base model is bitwise unchanged, a
repeated call gives identical draws, ``draw_seed`` changes them, and the
output is (m, S * D) with columns grouped by scenario.
"""

import datetime as dt

import numpy as np
import pytest
import torch
from _jax_state import jax_weekly_state

import nowcastautogp_tpu as jngp
import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.inference import resample as jresample
from nowcastautogp_tpu.ops import lml as jlml
from nowcastautogp_tpu_torch import nowcast
from nowcastautogp_tpu_torch.models.gp_model import GPModel
from nowcastautogp_tpu_torch.ops import forecast_scan, lml

torch.set_num_threads(1)

P, N_TRAIN, HORIZON, S = 8, 24, 3, 3
DELTA_RTOL, DELTA_ATOL = 1e-4, 1e-3
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4
# per branch: (draws per scenario, share of the 90% spread at the 5%, 50%
# and 95% quantiles)
BRANCHES = {
    "serial": (200, (0.3, 0.15, 0.25)),
    "n_hmc": (200, (0.3, 0.15, 0.25)),
    "n_mcmc": (200, (0.7, 0.35, 0.45)),
    "forecast_n_hmc": (24, (0.9, 0.6, 0.75)),
}


def _series(n=N_TRAIN + 2 + HORIZON, seed=0):
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    return dates, np.log(800 * np.exp(0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
                                      + 0.12 * rng.standard_normal(n)))


def _inputs(create, offsets=(0.0, 0.0, 0.0)):
    """(nowcast scenarios sharing two dates, the serial branch's scenarios
    -- the third lacks the last nowcast date --, forecast dates)."""
    dates, y = _series()
    draws = (y[N_TRAIN:N_TRAIN + 2]
             + np.random.default_rng(1).normal(0.0, 0.05, (S, 2))
             + np.asarray(offsets)[:, None])
    nc_dates = dates[N_TRAIN:N_TRAIN + 2]
    shared = create(list(draws), nc_dates)
    serial = shared[:2] + create([draws[2][:1]], nc_dates[:1])
    return shared, serial, dates[N_TRAIN + 2:]


def _options(branch):
    return {"forecast_n_hmc": dict(forecast_n_hmc=1),
            "n_mcmc": dict(n_mcmc=1, n_hmc=1)}.get(
                branch, dict(n_hmc=1, ess_threshold=0.5))


@pytest.fixture(scope="session")
def state(tmp_path_factory):
    """The JAX state on the first 24 weeks of ``_series``, built once per
    session (``_jax_state``)."""
    return jax_weekly_state(tmp_path_factory)


def _port(state):
    return GPModel.from_jax_state(state, device="cpu")


def _jax_rows(state, ncs):
    """The batched branch's per-row buffers as the JAX package builds them
    (``nowcast.py:471-494``), from the JAX model itself."""
    jm = jngp.GPModel(state)
    n0 = jm.n_ingested
    n_new = n0 + len(ncs[0].ds)
    cap = max(jm._cap, int(np.ceil(n_new / 32)) * 32)
    x_row = np.zeros(cap, np.float32)
    x_row[:n0] = np.asarray(jm._x_d)[:n0]
    x_row[n0:n_new] = jm._normalize_dates(ncs[0].ds)
    y_rows = np.zeros((len(ncs), cap), np.float32)
    y_rows[:, :n0] = np.asarray(jm._y_d)[:n0]
    for s, nc in enumerate(ncs):
        y_rows[s, n0:n_new] = (np.asarray(nc.y) - jm._y_mean) / jm._y_std
    mask_old = (np.arange(cap) < n0).astype(np.float32)
    mask_new = (np.arange(cap) < n_new).astype(np.float32)
    return jm, x_row, y_rows, mask_old, mask_new


def test_reweight_deltas_match_jax(state, monkeypatch):
    """Old and new LMLs of every row and the deltas, with particle 0 broken
    (NaN parameters) so its rows carry the sentinel."""
    state = dict(state, params=state["params"].copy())
    state["params"][0] = np.nan
    recorded = []
    guard = nowcast._reweight_delta

    def recording(lml_old, lml_new):
        out = guard(lml_old, lml_new)
        recorded.append((lml_old, lml_new, out))
        return out

    monkeypatch.setattr(nowcast, "_reweight_delta", recording)
    ncs, _, f_dates = _inputs(ngp.create_nowcast_data)
    ngp.forecast_with_nowcasts(_port(state), ncs, f_dates, 2, n_hmc=1)
    (lml_old, lml_new, delta), = recorded

    jm, x_row, y_rows, mask_old, mask_new = _jax_rows(state, ncs)
    R, cap = S * P, x_row.shape[0]
    args = (np.tile(jm._host_types, (S, 1)),
            np.tile(np.asarray(jm._params_d), (S, 1, 1)),
            np.tile(np.asarray(jm._log_noise_d), S),
            np.broadcast_to(x_row, (R, cap)), np.repeat(y_rows, P, axis=0))
    ref = [np.asarray(jlml.gp_lml_batch(
        *args, np.broadcast_to(m, (R, cap)), jlml.DEFAULT_JITTER), np.float64)
        for m in (mask_old, mask_new)]
    ref_delta = np.where((ref[0] <= -1e9) | (ref[1] <= -1e9), -1e10,
                         ref[1] - ref[0])
    broken = np.arange(R) % P == 0
    assert np.all(ref[1][broken] == -1e10)
    for got, want in zip((lml_old, lml_new, delta), (*ref, ref_delta)):
        np.testing.assert_allclose(got, want, rtol=DELTA_RTOL,
                                   atol=DELTA_ATOL)
    np.testing.assert_array_equal(delta[broken], -1e10)
    # the guard on either side: a broken OLD value must not give +1e10
    old = np.array([-1e10, 0.0, -3.0, -1e10])
    new = np.array([-2.0, -1e10, -1.0, -1e10])
    np.testing.assert_array_equal(guard(old, new), [-1e10, -1e10, 2.0, -1e10])


def test_resample_rows_bitwise_jax(state, monkeypatch):
    """The per-scenario resample indices and weights from one numpy seed
    are the JAX package's loop's (``nowcast.py:533-551``), bitwise, on the
    log-weights of a real call."""
    recorded = []
    resample_rows = nowcast._resample_rows

    def recording(rng, log_w, S_, P_, thr):
        recorded.append((log_w.copy(), thr))
        return resample_rows(rng, log_w, S_, P_, thr)

    monkeypatch.setattr(nowcast, "_resample_rows", recording)
    ncs, _, f_dates = _inputs(ngp.create_nowcast_data, (0.0, 0.3, -0.3))
    ngp.forecast_with_nowcasts(_port(state), ncs, f_dates, 2, n_hmc=1,
                               ess_threshold=0.9)
    (log_w0, thr), = recorded
    for seed in (0, 1, 2):
        got_idx, got_w, got_any = resample_rows(
            np.random.default_rng(seed), log_w0.copy(), S, P, thr)
        rng = np.random.default_rng(seed)
        want_w = log_w0.copy()
        want_idx = np.arange(S * P, dtype=np.int32)
        want_any = False
        for s in range(S):
            sl = slice(s * P, (s + 1) * P)
            if jresample.ess(want_w[sl]) < thr * P:
                want_idx[sl] = jresample.resample_indices(rng, want_w[sl]) \
                    + s * P
                want_w[sl] = 0.0
                want_any = True
        assert want_any and got_any == want_any
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got_w, want_w)


def test_scan_refreshes_every_row_and_predicts_as_jax(state, monkeypatch):
    """Two draws with two HMC steps each: every refresh covers all S x P
    rows and chains from the last, and each draw's predictive (one drawn
    row per scenario) equals JAX's at the refreshed hyperparameters on
    JAX's own scenario rows."""
    draws, n_hmc = 2, 2
    refreshes, predictives = [], []
    run_hmc, predict = forecast_scan.run_hmc, forecast_scan.gp_predict_batch

    def recording_hmc(*args, **kw):
        out = run_hmc(*args, **kw)
        refreshes.append((args[1], kw["n_steps"], out))
        return out

    def recording_predict(*args):
        out = predict(*args)
        predictives.append((args, out))
        return out

    monkeypatch.setattr(forecast_scan, "run_hmc", recording_hmc)
    monkeypatch.setattr(forecast_scan, "gp_predict_batch", recording_predict)
    ncs, _, f_dates = _inputs(ngp.create_nowcast_data)
    out = ngp.forecast_with_nowcasts(_port(state), ncs, f_dates, draws,
                                     forecast_n_hmc=n_hmc)
    assert out.shape == (HORIZON, S * draws)
    assert len(refreshes) == len(predictives) == draws
    jm, x_row, y_rows, _, mask_new = _jax_rows(state, ncs)
    xs = np.asarray(jm._normalize_dates(f_dates), np.float32)
    params = torch.as_tensor(np.tile(state["params"], (S, 1, 1)))
    for (p_in, n_steps, hmc_out), (args, (mu, cov)) in zip(refreshes,
                                                            predictives):
        assert n_steps == n_hmc and p_in.shape[0] == S * P
        torch.testing.assert_close(p_in, params, rtol=0, atol=0)
        params = hmc_out[0]
        types, p, ln, x, y, m = (a.numpy() for a in args[:6])
        # one drawn row per scenario, in order, from that scenario's block
        # of the refreshed rows
        np.testing.assert_array_equal(y, y_rows)
        np.testing.assert_array_equal(x, np.broadcast_to(x_row, x.shape))
        np.testing.assert_array_equal(m, np.broadcast_to(mask_new, m.shape))
        blocks = params.numpy().reshape(S, P, -1, 3)
        assert all((blocks[s] == p[s]).all((1, 2)).any() for s in range(S))
        jmu, jcov = jlml.gp_predict_batch(
            types, p, ln, np.broadcast_to(x_row, x.shape), y_rows,
            np.broadcast_to(mask_new, m.shape), xs, jlml.DEFAULT_JITTER,
            True)
        np.testing.assert_allclose(mu.numpy(), jmu, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
        np.testing.assert_allclose(cov.numpy(), jcov, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_draws_agree_with_jax_in_distribution(state, branch):
    D, shares = BRANCHES[branch]
    jshared, jserial, f_dates = _inputs(jngp.create_nowcast_data)
    pshared, pserial, _ = _inputs(ngp.create_nowcast_data)
    jncs, pncs = ((jserial, pserial) if branch == "serial"
                  else (jshared, pshared))
    ref = jngp.forecast_with_nowcasts(jngp.GPModel(state), jncs, f_dates, D,
                                      **_options(branch))
    got = ngp.forecast_with_nowcasts(_port(state), pncs, f_dates, D,
                                     **_options(branch))
    assert got.shape == ref.shape == (HORIZON, S * D)
    assert np.all(np.isfinite(got))
    _quantiles_agree(got, ref, D, shares)


@pytest.mark.parametrize("branch", ["serial", "n_hmc", "n_mcmc",
                                    "forecast_n_hmc"])
def test_branch_contracts(state, branch):
    """The base model is bitwise unchanged; a repeated call repeats the
    draws and ``draw_seed`` changes them; scenarios nowcast a log-level
    3 apart land in their own column blocks, in order."""
    D = 6
    shared, serial, f_dates = _inputs(ngp.create_nowcast_data,
                                      (-3.0, 0.0, 3.0))
    ncs = serial if branch == "serial" else shared
    kw = _options(branch)
    pm = _port(state)
    before = pm.to_dict()
    out = ngp.forecast_with_nowcasts(pm, ncs, f_dates, D, **kw)
    after = pm.to_dict()
    for key, value in before.items():
        if isinstance(value, np.ndarray) and value.dtype != object:
            assert value.tobytes() == after[key].tobytes(), key
        elif isinstance(value, np.ndarray):
            assert np.array_equal(value, after[key]), key
        else:
            assert value == after[key], key
    assert out.shape == (HORIZON, S * D)
    np.testing.assert_array_equal(
        out, ngp.forecast_with_nowcasts(pm, ncs, f_dates, D, **kw))
    assert not np.array_equal(out, ngp.forecast_with_nowcasts(
        pm, ncs, f_dates, D, draw_seed=7, **kw))
    block_medians = np.median(out[0].reshape(S, D), axis=1)
    assert np.all(np.diff(block_medians) > 0.5), block_medians


def _quantiles_agree(got, ref, D, shares):
    qs = [0.05, 0.5, 0.95]
    q_ref = np.quantile(ref.reshape(HORIZON, S, D), qs, axis=-1)
    q_got = np.quantile(got.reshape(HORIZON, S, D), qs, axis=-1)
    spread = q_ref[2] - q_ref[0]
    assert np.all(spread > 0)
    tol = np.asarray(shares)[:, None, None] * spread
    assert np.all(np.abs(q_got - q_ref) <= tol), (q_got, q_ref, tol)


def test_scenario_chunks_keep_the_contract(state, monkeypatch):
    """A chunk budget too small for two scenarios: one batched call per
    scenario, in order; the output keeps its shape, its scenario column
    blocks and its repeatability, and its draws agree in distribution with
    the one-call draws."""
    D, shares = BRANCHES["n_hmc"]
    shared, _, f_dates = _inputs(ngp.create_nowcast_data, (-3.0, 0.0, 3.0))
    pm = _port(state)
    whole = ngp.forecast_with_nowcasts(pm, shared, f_dates, D, n_hmc=1)
    calls = []
    batched = nowcast._forecast_with_nowcasts_batched

    def recording(model, ncs, *args, **kw):
        calls.append([float(nc.y[-1]) for nc in ncs])
        return batched(model, ncs, *args, **kw)

    monkeypatch.setattr(lml, "_CHUNK_BYTES", 1)
    monkeypatch.setattr(nowcast, "_forecast_with_nowcasts_batched",
                        recording)
    out = ngp.forecast_with_nowcasts(pm, shared, f_dates, D, n_hmc=1)
    assert calls == [[float(nc.y[-1])] for nc in shared]
    assert out.shape == whole.shape == (HORIZON, S * D)
    np.testing.assert_array_equal(
        out, ngp.forecast_with_nowcasts(pm, shared, f_dates, D, n_hmc=1))
    block_medians = np.median(out[0].reshape(S, D), axis=1)
    assert np.all(np.diff(block_medians) > 0.5), block_medians
    _quantiles_agree(out, whole, D, shares)
