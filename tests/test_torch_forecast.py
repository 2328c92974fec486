"""Port parity: the plain forecaster (``predict_mvn``, ``MvNormalMixture``,
``forecast``), a tiny fit through the composed LML path, and the entry
points' default device.

The JAX model and the port's copy of its state (``from_jax_state``) give
the same predictive mixture to float32 tolerance; ``MvNormalMixture`` is
numpy in both packages, so its draws are bitwise equal for the same inputs
and generator state.  Shapes match ``tests/test_torch_slice.py``'s (8 rows,
7 heap slots, capacity 32, 4 forecast dates), so the JAX side compiles the
programs that file compiles.
"""

import datetime as dt
import inspect

import numpy as np
import pytest
import torch
from _jax_state import jax_weekly_state

import nowcastautogp_tpu as jngp
import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.models.posterior import MvNormalMixture as JMixture
from nowcastautogp_tpu_torch.models.gp_model import GPModel
from nowcastautogp_tpu_torch.ops import lml

torch.set_num_threads(1)

P, N_TRAIN, HORIZON = 8, 24, 4
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4


def _series(n, seed=0, weeks=True):
    step = dt.timedelta(weeks=1) if weeks else dt.timedelta(days=1)
    dates = [dt.date(2022, 1, 3) + i * step for i in range(n)]
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    obs = 800 * np.exp(0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
                       + 0.12 * rng.standard_normal(n))
    return dates, obs


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A JAX model after one reweight on the first 24 weeks of ``_series``
    (``_jax_state``'s state, built once a session), and the port's copy of
    its state."""
    state = jax_weekly_state(tmp_path_factory)
    dates, _ = _series(N_TRAIN + HORIZON)
    return (jngp.GPModel(state), GPModel.from_jax_state(state, device="cpu"),
            dates)


def test_predict_mvn_matches_jax(models):
    jm, pm, dates = models
    f_dates = dates[N_TRAIN:]
    ref = jngp.predict_mvn(jm, f_dates)
    got = ngp.predict_mvn(pm, f_dates)
    np.testing.assert_array_equal(got.weights, ref.weights)
    np.testing.assert_allclose(got.means, ref.means, rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(got.covs, ref.covs, rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    noiseless = ngp.predict_mvn(pm, f_dates, include_noise=False)
    assert np.all(np.diagonal(noiseless.covs, axis1=1, axis2=2)
                  < np.diagonal(got.covs, axis1=1, axis2=2))


def test_mixture_sample_is_bitwise_jax(models):
    jm, _, dates = models
    ref = jngp.predict_mvn(jm, dates[N_TRAIN:])
    a = ngp.MvNormalMixture(ref.weights, ref.means, ref.covs)
    b = JMixture(ref.weights, ref.means, ref.covs)
    got = a.sample(np.random.default_rng(11), 300)
    np.testing.assert_array_equal(got, b.sample(np.random.default_rng(11), 300))
    assert got.shape == (HORIZON, 300)
    np.testing.assert_array_equal(
        a.marginal_quantiles([0.1, 0.9], n_draws=200),
        b.marginal_quantiles([0.1, 0.9], n_draws=200))
    np.testing.assert_array_equal(a.mean(), b.mean())


def test_forecast_matches_jax(models):
    """Same state and numpy generator on both sides: the same mixture
    components are drawn with the same normals, so the draws agree to the
    predictive's tolerance and both generators advance alike."""
    jm0, _, dates = models
    jm = jngp.GPModel(jm0.to_dict())
    pm = GPModel.from_jax_state(jm0.to_dict(), device="cpu")
    ref = jngp.forecast(jm, dates[N_TRAIN:], 200, inv_transformation=np.exp)
    got = ngp.forecast(pm, dates[N_TRAIN:], 200, inv_transformation=np.exp)
    assert got.shape == (HORIZON, 200)
    np.testing.assert_allclose(np.log(got), np.log(ref), rtol=PRED_RTOL,
                               atol=10 * PRED_ATOL)
    assert pm.rng.bit_generator.state == jm.rng.bit_generator.state


def test_tiny_fit_through_the_composed_path_then_forecast(monkeypatch):
    """Two schedule steps whose last capacity is 544, so the fit's last
    step (reweight, proposal LML, HMC) runs the composed core's glue, then
    the plain forecaster at that capacity."""
    calls = []
    composed = lml.lml_core_composed
    monkeypatch.setattr(lml, "lml_core_composed",
                        lambda *a: calls.append(a[4].shape[-1])
                        or composed(*a))
    n_train = 530
    dates, obs = _series(n_train + 7, weeks=False)
    fwd, inv = ngp.get_transformations("boxcox", obs[:n_train])
    data = ngp.create_transformed_data(dates[:n_train], obs[:n_train],
                                       transformation=fwd)
    model = ngp.make_and_fit_model(
        data, n_particles=2, smc_data_proportion=0.5, n_mcmc=1, n_hmc=1,
        seed=2, config=ngp.GPConfig(max_depth=3),
        hmc_config=ngp.HMCConfig(n_leapfrog=1), device="cpu")
    assert model._cap == 544 and model.n_ingested == n_train
    assert calls and set(calls) == {544}
    assert np.all(np.isfinite(model._lml_d.numpy()))
    fc = ngp.forecast(model, dates[n_train:], 50, inv_transformation=inv)
    assert fc.shape == (7, 50)
    assert np.all(np.isfinite(fc)) and np.all(fc >= 0)


@pytest.mark.parametrize("fn", [
    ngp.make_and_fit_model, GPModel.__init__, GPModel.from_jax_state,
    ngp.quantile_matrix_device, ngp.fit_panel,
])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
