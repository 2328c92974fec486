"""Port parity: the multi-series panel (``fit_panel``, ``panel_predict_mvn``,
``forecast_panel``).

The panel: S = 2 series of 24 and 30 weeks (capacity 64, schedule
segments at 32 and 64), P = 4 depth-3 particles each, seed 3.

* Without moves (``n_mcmc=0, n_hmc=0``) a panel fit is reweights and
  per-series resamples only, so it is held against the JAX package's
  ``fit_panel(engine="host")`` step by step: the data orders, the initial
  particles, every resample's indices and the final trees and parameters
  bitwise (one numpy stream in both), the log weights and LMLs to float32
  tolerance (rtol 1e-5, atol 1e-4), and each series' generators as
  ``from_jax_state`` derives them from JAX's key.
* With moves (``n_mcmc=1, n_hmc=1``, both engines) the generators differ
  (threefry against torch), so the per-series contract is held: every
  model's cached LML is the LML of its own data (rtol 1e-5, atol 1e-4).
* The predictive of JAX-fitted models carried across with
  ``from_jax_state``: means and covariances at rtol 1e-3, atol 1e-4 (the
  tolerance of ``tests/test_torch_forecast.py``), weights bitwise.  The
  sampling factors are eigendecompositions whose column signs may differ
  between the two packages, so the draws are held bitwise on JAX's own
  moments: fed the JAX package's ``_panel_predict_rows``, the port's
  numpy draws at one seed equal JAX's ``forecast_panel``'s.
"""

import datetime as dt

import numpy as np
import pytest
import torch
from _session_once import once_per_session

import nowcastautogp_tpu as jngp
import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.parallel import panel as jpanel
from nowcastautogp_tpu_torch.models.gp_model import GPModel
from nowcastautogp_tpu_torch.ops import lml
from nowcastautogp_tpu_torch.parallel import panel

torch.set_num_threads(1)

P, LENS, SEED, HORIZON = 4, (24, 30), 3, 3
LW_RTOL, LW_ATOL = 1e-5, 1e-4
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4


def _datasets(pkg):
    out = []
    for s, n in enumerate(LENS):
        dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i)
                 for i in range(n)]
        t = np.arange(n)
        rng = np.random.default_rng(s)
        y = 6.5 + 0.6 * np.sin(2 * np.pi * t / 26 + s) \
            + 0.12 * rng.standard_normal(n)
        out.append(pkg.create_transformed_data(dates, y))
    return out


def _forecast_dates():
    return [dt.date(2022, 1, 3) + dt.timedelta(weeks=max(LENS) + i)
            for i in range(HORIZON)]


def _kw(pkg):
    return dict(n_particles=P, seed=SEED, config=pkg.GPConfig(max_depth=3))


def _recording_resample(module, calls):
    inner = module.resample_indices

    def recording(rng, log_w, *args):
        out = inner(rng, log_w, *args)
        calls.append(np.asarray(out))
        return out
    return recording


INVS = (np.exp, lambda y: 2.0 * y)
N_DRAWS, DRAW_SEED = 40, 4


def _jax_refs():
    """JAX's panel fit without moves (model states), its resample indices,
    and on the fitted models its predictive mixtures (weights, means,
    covariances), its ``_panel_predict_rows`` moments and its
    ``forecast_panel`` draws."""
    calls = []
    saved = jpanel.resample_indices
    jpanel.resample_indices = _recording_resample(jpanel, calls)
    try:
        models = jngp.fit_panel(_datasets(jngp), n_mcmc=0, n_hmc=0,
                                engine="host", **_kw(jngp))
    finally:
        jpanel.resample_indices = saved
    f_dates = _forecast_dates()
    mvns = [(m.weights, m.means, m.covs)
            for m in jngp.panel_predict_mvn(models, f_dates)]
    moments = jpanel._panel_predict_rows(models, f_dates,
                                         include_noise=True, mesh=None)
    draws = jngp.forecast_panel(models, f_dates, N_DRAWS,
                                inv_transformations=list(INVS),
                                seed=DRAW_SEED)
    return dict(states=[m.to_dict() for m in models], resamples=calls,
                mvns=mvns, moments=moments, draws=draws)


@pytest.fixture(scope="session")
def jax_refs(tmp_path_factory):
    """``_jax_refs``, built once per session."""
    return once_per_session(tmp_path_factory, "panel_jax_refs", _jax_refs)


def test_fit_without_moves_matches_jax(jax_refs, monkeypatch):
    jstates, jcalls = jax_refs["states"], jax_refs["resamples"]
    calls = []
    monkeypatch.setattr(panel, "resample_indices",
                        _recording_resample(panel, calls))
    models = ngp.fit_panel(_datasets(ngp), n_mcmc=0, n_hmc=0, engine="host",
                           device="cpu", **_kw(ngp))
    assert jcalls and len(calls) == len(jcalls)
    for got, want in zip(calls, jcalls):
        np.testing.assert_array_equal(got, want)
    assert len(models) == len(jstates) == len(LENS)
    for model, js in zip(models, jstates):
        d = model.to_dict()
        for key in ("y", "order", "node_types", "params", "log_noise",
                    "hmc_eps_scale"):
            np.testing.assert_array_equal(d[key], js[key], err_msg=key)
        for key in ("n_ingested", "t0", "t_scale", "y_mean", "y_std",
                    "rng_state"):
            assert d[key] == js[key], key
        for key in ("log_weight", "lml"):
            np.testing.assert_allclose(d[key], js[key], rtol=LW_RTOL,
                                       atol=LW_ATOL, err_msg=key)
        carried = GPModel.from_jax_state(js, device="cpu")
        np.testing.assert_array_equal(d["generator_state"],
                                      carried.to_dict()["generator_state"])


def _own_lml(model):
    x, y, m = model._batched_data()
    with torch.no_grad():
        return lml.gp_lml_batched(model._types_d(), model._params_d,
                                  model._log_noise_d, x, y, m).numpy()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_fit_with_moves_keeps_the_per_series_contract(engine):
    datasets = _datasets(ngp)
    models = ngp.fit_panel(datasets, n_mcmc=1, n_hmc=1, engine=engine,
                           device="cpu", **_kw(ngp))
    assert len(models) == len(LENS)
    for model, d, n in zip(models, datasets, LENS):
        assert model.num_particles == P and model.n_ingested == n
        assert model.log_weight.shape == (P,)
        assert np.all(np.isfinite(model.log_weight))
        np.testing.assert_array_equal(model.y, np.asarray(d.y, np.float64))
        cached = model._lml_d.numpy()
        assert np.all(cached > -1e9)
        np.testing.assert_allclose(cached, _own_lml(model), rtol=LW_RTOL,
                                   atol=LW_ATOL)


def _carried(jstates):
    return [GPModel.from_jax_state(js, device="cpu") for js in jstates]


def test_panel_predict_mvn_matches_jax(jax_refs):
    got = ngp.panel_predict_mvn(_carried(jax_refs["states"]),
                                _forecast_dates())
    assert len(got) == len(jax_refs["mvns"]) == len(LENS)
    for g, (weights, means, covs) in zip(got, jax_refs["mvns"]):
        np.testing.assert_array_equal(g.weights, weights)
        np.testing.assert_allclose(g.means, means, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
        np.testing.assert_allclose(g.covs, covs, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)


def test_forecast_panel_draws_bitwise_on_jax_moments(jax_refs, monkeypatch):
    pmodels = _carried(jax_refs["states"])
    f_dates = _forecast_dates()
    own = ngp.forecast_panel(pmodels, f_dates, N_DRAWS,
                             inv_transformations=list(INVS), seed=DRAW_SEED)
    for o in own:
        assert o.shape == (HORIZON, N_DRAWS) and np.all(np.isfinite(o))
    monkeypatch.setattr(panel, "_panel_predict_rows",
                        lambda *a, **k: jax_refs["moments"])
    got = ngp.forecast_panel(pmodels, f_dates, N_DRAWS,
                             inv_transformations=list(INVS), seed=DRAW_SEED)
    for g, r in zip(got, jax_refs["draws"]):
        np.testing.assert_array_equal(g, r)


def test_rows_beyond_the_chunk_budget_raise(monkeypatch):
    """The panel's S x P rows are held to the nowcast's row budget."""
    monkeypatch.setattr(lml, "_CHUNK_BYTES",
                        lml.budget_bytes(len(LENS) * P - 1, 64))
    with pytest.raises(ValueError, match="row budget"):
        ngp.fit_panel(_datasets(ngp), n_mcmc=0, n_hmc=0, device="cpu",
                      **_kw(ngp))
