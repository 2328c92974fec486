"""Port parity: the per-draw-HMC forecaster, ``forecast(..., forecast_n_hmc=1)``.

Both packages start from one JAX state -- P = 8 depth-3 particles
reweighted on 24 weeks (capacity 32), the state ``tests/test_torch_forecast.py``
builds -- carried across by ``from_jax_state``, and draw D = 48 joint
samples at 3 dates with one HMC step before each.  The port runs on both
"pallas" backends (the K7 covariances and the K6 core, whose plain versions
run here), JAX on its default path.

The two use different generators (threefry against the torch CPU
generator), so the draws are held in distribution: per date, the medians
within 0.3 and the 5% and 95% quantiles within 0.6 of the JAX draws' 90%
spread (q95 - q05).  Draws after successive HMC refreshes are correlated,
so a 48-draw quantile is noisy: from this state, ten successive 48-draw
blocks of the JAX sampler span up to 0.59 of the spread at the 5% quantile
and 0.29 at the median, and the tolerances are those spans rounded up; at
400 draws the two samplers agree to 0.04 of the spread at every quantile,
but 400 port draws take about a minute on one CPU thread.

What that tolerance cannot see is held exactly instead:

* every draw follows its own refresh: ``run_hmc`` runs once per draw with
  ``n_steps = forecast_n_hmc``, each from the state the previous one left,
  and the draw's predictive is built from the refreshed state, which the
  model keeps at the end;
* each draw's predictive mean and covariance equal JAX's ``gp_predict_batch``
  at the same refreshed hyperparameters (rtol 1e-3, atol 1e-4, the
  tolerance of ``tests/test_torch_forecast.py``), so a wrong predictive
  variance cannot hide in the sampling noise;
* each particle's step scale took exactly D adaptations: log(s_D / s_0) /
  0.05 + 0.65 D, the accepted count, is an integer in [0, D];
* the mean acceptance rate this gives is JAX's within 0.15: over six JAX
  keys and four torch seeds it lay in [0.88, 0.99] for both.
"""

import datetime as dt

import numpy as np
import pytest
import torch
from _jax_state import jax_weekly_state
from _session_once import once_per_session

import nowcastautogp_tpu as jngp
import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.ops import lml as jlml
from nowcastautogp_tpu_torch.inference import hmc
from nowcastautogp_tpu_torch.models.gp_model import GPModel
from nowcastautogp_tpu_torch.ops import cov, forecast_scan, lml

torch.set_num_threads(1)

P, N_TRAIN, HORIZON, DRAWS = 8, 24, 3, 48
MEDIAN_TOL, TAIL_TOL = 0.3, 0.6
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4
ACCEPT_TOL = 0.15


def _series(n, seed=0):
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    obs = 800 * np.exp(0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
                       + 0.12 * rng.standard_normal(n))
    return dates, obs


def _pallas_forecast(pm, dates, draws, n_hmc):
    saved = lml._LML_BACKEND, cov._COV_BACKEND
    lml.set_lml_backend("pallas")
    cov.set_cov_backend("pallas")
    try:
        return ngp.forecast(pm, dates, draws, forecast_n_hmc=n_hmc)
    finally:
        lml._LML_BACKEND, cov._COV_BACKEND = saved


def _accepted(scale_after, scale_before, n_steps):
    """Accepted trajectories per particle, from the adapted step scales."""
    return (np.log(scale_after / scale_before) / hmc._ADAPT_RATE
            + hmc._TARGET_ACCEPT * n_steps)


@pytest.fixture(scope="session")
def state(tmp_path_factory):
    """The JAX state both packages start from (``_jax_state``'s, on the
    first 24 weeks of ``_series``), and the forecast dates."""
    return (jax_weekly_state(tmp_path_factory),
            _series(N_TRAIN + HORIZON)[0][N_TRAIN:])


def _jax_runs(state, f_dates):
    jm = jngp.GPModel(state)
    ref = jngp.forecast(jm, f_dates, DRAWS, forecast_n_hmc=1)
    return dict(ref=ref, jax_after=jm.to_dict())


def _port_runs(state, f_dates):
    pm = GPModel.from_jax_state(state, device="cpu")
    before = pm.to_dict()
    got = _pallas_forecast(pm, f_dates, DRAWS, 1)
    return dict(got=got, before=before, after=pm.to_dict())


@pytest.fixture(scope="session")
def jax_runs(tmp_path_factory, state):
    """JAX's forecast (log scale) and its model's state after."""
    return once_per_session(tmp_path_factory,
                            "forecast_hmc_jax", lambda: _jax_runs(*state))


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory, state):
    """The port's forecast (log scale) and its model's state before and
    after."""
    return once_per_session(tmp_path_factory,
                            "forecast_hmc_port", lambda: _port_runs(*state))


@pytest.fixture
def runs(jax_runs, port_runs):
    """Both forecasts and states: each half is built once per session,
    the two halves possibly by two workers at once."""
    return {**jax_runs, **port_runs}


def test_shapes_and_values(runs):
    ref, got = runs["ref"], runs["got"]
    assert got.shape == ref.shape == (HORIZON, DRAWS)
    assert np.all(np.isfinite(got))


def test_draws_agree_with_jax_in_distribution(runs):
    ref, got = runs["ref"], runs["got"]
    q_ref = np.quantile(ref, [0.05, 0.5, 0.95], axis=1)
    q_got = np.quantile(got, [0.05, 0.5, 0.95], axis=1)
    spread = q_ref[2] - q_ref[0]
    assert np.all(spread > 0)
    tol = np.array([TAIL_TOL, MEDIAN_TOL, TAIL_TOL])[:, None] * spread
    assert np.all(np.abs(q_got - q_ref) <= tol), (q_got, q_ref, tol)


def test_the_model_is_mutated_between_draws(port_runs):
    """Hyperparameters moved and every particle's step scale took exactly
    one adaptation per draw, as the reference mutates the model; weights
    and the numpy generator are untouched."""
    before, after = port_runs["before"], port_runs["after"]
    assert np.any(after["params"] != before["params"])
    assert np.any(after["log_noise"] != before["log_noise"])
    s0, s1 = before["hmc_eps_scale"], after["hmc_eps_scale"]
    lo, hi = hmc._SCALE_BOUNDS
    assert np.all((s1 > lo) & (s1 < hi)), s1      # no clamp hides a step
    n_acc = _accepted(s1, s0, DRAWS)
    np.testing.assert_allclose(n_acc, np.round(n_acc), rtol=0, atol=1e-3)
    assert np.all((n_acc > -0.5) & (n_acc < DRAWS + 0.5)), n_acc
    assert np.all(np.isfinite(after["lml"]))
    np.testing.assert_array_equal(after["log_weight"], before["log_weight"])
    assert after["rng_state"] == before["rng_state"]


def test_acceptance_agrees_with_jax(runs):
    s0 = runs["before"]["hmc_eps_scale"]
    rates = [_accepted(after["hmc_eps_scale"], s0, DRAWS).mean() / DRAWS
             for after in (runs["after"], runs["jax_after"])]
    assert abs(rates[0] - rates[1]) <= ACCEPT_TOL, rates


def test_each_draw_is_sampled_from_its_own_refresh(state, monkeypatch):
    """Three draws with two HMC steps each: the refreshes chain, each
    draw's predictive is built from its refreshed state and equals JAX's
    there (JAX's own data, test points, jitter and noise), sampling factors
    that predictive, and the model keeps the last state."""
    draws, n_hmc = 3, 2
    refreshes, predictives, factored = [], [], []
    run_hmc, predict = forecast_scan.run_hmc, forecast_scan.gp_predict_batch
    factor = forecast_scan.sampling_cholesky

    def recording_hmc(*args, **kw):
        out = run_hmc(*args, **kw)
        refreshes.append((args[1], args[2], kw["eps_scale"], kw["n_steps"],
                          out))
        return out

    def recording_predict(*args):
        out = predict(*args)
        predictives.append((args, out))
        return out

    def recording_factor(covm):
        factored.append(covm)
        return factor(covm)

    monkeypatch.setattr(forecast_scan, "run_hmc", recording_hmc)
    monkeypatch.setattr(forecast_scan, "gp_predict_batch", recording_predict)
    monkeypatch.setattr(forecast_scan, "sampling_cholesky", recording_factor)
    jstate, f_dates = state
    jm = jngp.GPModel(jstate)
    jdata = (jm._host_types, *jm._batched_data())
    jxs = np.asarray(jm._normalize_dates(f_dates), np.float32)
    pm = GPModel.from_jax_state(jstate, device="cpu")
    state = pm._params_d, pm._log_noise_d, pm._eps_scale_d
    _pallas_forecast(pm, f_dates, draws, n_hmc)
    assert len(refreshes) == len(predictives) == len(factored) == draws
    for (p, ln, scale, n_steps, out), (args, (mu, covm)), f in zip(
            refreshes, predictives, factored):
        assert n_steps == n_hmc
        for a, b in zip((p, ln, scale), state):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert args[1] is out[0] and args[2] is out[1] and f is covm
        state = out[0], out[1], out[4]
        jmu, jcov = jlml.gp_predict_batch(
            jdata[0], out[0].numpy(), out[1].numpy(), *jdata[1:], jxs,
            jlml.DEFAULT_JITTER, True)
        np.testing.assert_allclose(mu.numpy(), jmu, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
        np.testing.assert_allclose(covm.numpy(), jcov, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
    for a, b in zip((pm._params_d, pm._log_noise_d, pm._eps_scale_d), state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forecast_n_hmc_must_be_positive(state):
    pm = GPModel.from_jax_state(state[0], device="cpu")
    with pytest.raises(ValueError, match="forecast_n_hmc"):
        ngp.forecast(pm, _series(N_TRAIN + 1)[0][N_TRAIN:], 2,
                     forecast_n_hmc=0)
