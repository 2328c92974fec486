"""Port parity: the workflow around the fit -- vintaged data, WIS, hubverse
submissions, the acceptance comparison, decomposition, checkpoints and the
phase timers.

* The numpy copies (``utils/data.py``, ``eval/wis.py``,
  ``eval/submission.py``, ``synthetic_nhsn_vintage``, ``score_forecast``,
  ``score_forecast_wis``) are bitwise the JAX package's on seeded inputs,
  the CSV bytes included.
* ``decompose`` of a JAX state carried across with ``from_jax_state``:
  each component's mean and variance at rtol 1e-3, atol 1e-4 (the
  predictive tolerance of ``tests/test_torch_forecast.py``), the
  structures equal, a particle with NaN parameters flagged broken in both;
  and the component means sum to the noise-free predictive mean.
* Checkpoints load across the packages and round trip.
* The phase timers have the JAX package's names and counts on the same
  tiny host fit; ``device_trace`` writes a trace on the CPU.
* ``run_acceptance`` at ``examples/acceptance.py --smoke``'s budget returns
  the JAX package's result schema.
"""

import datetime as dt
import json

import numpy as np
import pytest
import torch
from _jax_state import jax_weekly_state, weekly_series

import nowcastautogp_tpu as jngp
import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.eval import acceptance as jacc
from nowcastautogp_tpu.utils import profiling as jprof
from nowcastautogp_tpu_torch.eval import acceptance
from nowcastautogp_tpu_torch.inference.schedule import linear_schedule
from nowcastautogp_tpu_torch.inference.smc import schedule_segments
from nowcastautogp_tpu_torch.models.gp_model import GPModel
from nowcastautogp_tpu_torch.utils import profiling

torch.set_num_threads(1)

P, N_TRAIN, HORIZON = 8, 24, 4
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4


def _series(n=N_TRAIN + HORIZON, seed=0):
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    return dates, 6.5 + 0.6 * np.sin(2 * np.pi * t / 26 + 1.0) \
        + 0.12 * rng.standard_normal(n)


# ------------------------------------------------------------ numpy copies


def _vintage(pkg):
    return pkg.synthetic_nhsn_vintage(30, seed=4, log_mean=0.25, log_sd=0.1)


def _case_data(pkg, tmp_path):
    v = _vintage(pkg)
    rds = v.report_date_range()
    out = [rds, *v.snapshot(rds[10]), *v.confirmed(rds[12], n_redact=2),
           *v.provisional(rds[12], n_last=3), v.final(rds[:5])]
    path = tmp_path / "vintage.csv"
    with open(path, "w") as f:
        f.write("reference_date,report_date,confirm\n")
        for a, b, c in zip(v.reference_dates[:40], v.report_dates[:40],
                           v.values[:40]):
            f.write(f"{a},{b},{float(c)!r}\n")
    loaded = pkg.load_vintaged_csv(str(path))
    return out + [loaded.reference_dates, loaded.report_dates, loaded.values]


def _forecasts(n_dates=5, n_draws=300):
    rng = np.random.default_rng(11)
    return (rng.lognormal(6.0, 0.3, (n_dates, n_draws)),
            rng.lognormal(6.0, 0.3, n_dates))


def _case_wis(pkg, tmp_path):
    fc, obs = _forecasts()
    return [pkg.FLUSIGHT_QUANTILES,
            pkg.interval_score(fc[:, 0], fc[:, 1] + 50.0, 0.2, obs),
            np.asarray([pkg.wis_ensemble(fc[i], obs[i]) for i in range(5)]),
            pkg.wis_matrix(fc, obs),
            pkg.wis_matrix(fc, obs, quantiles=[0.1, 0.5, 0.9]),
            np.asarray(list(pkg.coverage_matrix(fc, obs, (0.5, 0.8, 0.9))
                            .items()))]


def _case_submission(pkg, tmp_path):
    fc, _ = _forecasts()
    dates = [dt.date(2024, 1, 6) + dt.timedelta(weeks=i) for i in range(5)]
    rows = pkg.quantile_submission(fc - 400.0, dates, location="06")
    rows2 = pkg.quantile_submission(
        fc, np.asarray(dates, dtype="datetime64[D]"),
        reference_date=dt.date(2023, 12, 30), nonnegative=False)
    path = tmp_path / f"{pkg.__name__}.csv"
    pkg.write_submission_csv(rows + rows2, str(path))
    return [json.dumps(rows + rows2).encode(), path.read_bytes()]


def _case_acceptance_scores(pkg, tmp_path):
    v = _vintage(pkg)
    fc, _ = _forecasts(4)
    rds = v.report_date_range()
    dates = list(rds[20:24])
    return [v.reference_dates, v.report_dates, v.values,
            pkg.eval.acceptance.score_forecast(v, dates, fc),
            pkg.eval.acceptance.score_forecast_wis(v, dates, fc,
                                                   max_horizon=3)]


@pytest.mark.parametrize("case", [_case_data, _case_wis, _case_submission,
                                  _case_acceptance_scores],
                         ids=["data", "wis", "submission", "acceptance"])
def test_numpy_copies_are_bitwise_jax(case, tmp_path):
    got = case(ngp, tmp_path)
    want = case(jngp, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, bytes):
            assert g == w
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes() if g.dtype != object \
                else np.array_equal(g, w)


# ---------------------------------------------------------- decomposition


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    """P = 8 depth-3 particles reweighted on 24 weeks (``_jax_state``'s
    state, built once a session) and 4 forecast dates."""
    return (jax_weekly_state(tmp_path_factory),
            weekly_series(N_TRAIN + HORIZON)[0][N_TRAIN:])


def test_decompose_matches_jax(jax_state, monkeypatch):
    """JAX's ``decompose`` runs its covariance steps eagerly, one primitive
    compile each (about 15 s here); the reference jits the two
    (``masked_kernel_matrix``, ``eval_cov``), which computes the same
    values."""
    import jax
    from nowcastautogp_tpu.models import decompose as jdecompose

    for name in ("masked_kernel_matrix", "eval_cov"):
        monkeypatch.setattr(jdecompose, name,
                            jax.jit(getattr(jdecompose, name)))
    state, f_dates = jax_state
    state = dict(state, params=state["params"].copy())
    state["params"][1] = np.nan
    ref = jngp.decompose(jngp.GPModel(state), f_dates)
    got = ngp.decompose(GPModel.from_jax_state(state, device="cpu"), f_dates)
    assert len(got) == len(ref) == P
    assert ref[1].get("broken") and got[1].get("broken")
    assert got[1]["components"] == []
    n_comp = 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        assert g["structure"] == r["structure"]
        assert g["weight"] == r["weight"]
        assert len(g["components"]) == len(r["components"])
        for gc, rc in zip(g["components"], r["components"]):
            n_comp += 1
            assert gc["structure"] == rc["structure"]
            for key in ("mean", "var"):
                assert gc[key].dtype == np.float64
                np.testing.assert_allclose(gc[key], rc[key], rtol=PRED_RTOL,
                                           atol=PRED_ATOL)
    assert n_comp > P  # some particle splits into several components


def test_components_sum_to_the_noise_free_mean(jax_state):
    state, f_dates = jax_state
    pm = GPModel.from_jax_state(state, device="cpu")
    mvn = ngp.predict_mvn(pm, f_dates, include_noise=False)
    for p, d in enumerate(ngp.decompose(pm, f_dates)):
        total = pm._y_mean + sum(c["mean"] for c in d["components"])
        np.testing.assert_allclose(total, mvn.means[p], rtol=PRED_RTOL,
                                   atol=PRED_ATOL)


# ------------------------------------------------------------- checkpoints


def _assert_same_state(a, b, skip=()):
    for key, value in a.items():
        if key in skip or key == "config":
            continue
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(np.asarray(b[key]), value,
                                          err_msg=key)
        else:
            assert b[key] == value, key


def test_checkpoints_load_across_packages(jax_state, tmp_path):
    state, _ = jax_state
    jm = jngp.GPModel(state)
    jngp.save_model(jm, str(tmp_path / "jax.npz"))
    pm = ngp.load_model(str(tmp_path / "jax.npz"), device="cpu")
    want = GPModel.from_jax_state(jm.to_dict(), device="cpu").to_dict()
    _assert_same_state(want, pm.to_dict(), skip=("ds",))
    assert pm.config.prior == jm.config.prior

    ngp.save_model(pm, str(tmp_path / "port.npz"))
    back = ngp.load_model(str(tmp_path / "port.npz"))
    assert back.device == torch.device("cpu")
    _assert_same_state(pm.to_dict(), back.to_dict(), skip=("ds",))
    np.testing.assert_array_equal(np.asarray(back.ds, "datetime64[D]"),
                                  np.asarray(pm.ds, "datetime64[D]"))

    jback = jngp.load_model(str(tmp_path / "port.npz"))
    jd = jback.to_dict()
    _assert_same_state({k: v for k, v in jm.to_dict().items()
                        if k != "key"}, jd, skip=("ds",))
    key = jd["key"]
    assert key.dtype == np.uint32 and key.shape == (2,) and key[0] == 0
    with np.load(str(tmp_path / "port.npz")) as z:
        np.testing.assert_array_equal(z["key"], key)
    jback.next_key()  # a usable threefry key


# ---------------------------------------------------------------- timers


def test_phase_report_names_and_device_trace(tmp_path):
    dates, y = _series()
    kw = dict(n_particles=4, smc_data_proportion=0.25, n_mcmc=0, n_hmc=0,
              seed=2, engine="host")
    jprof.reset_phases()
    jngp.make_and_fit_model(jngp.create_transformed_data(dates, y),
                            config=jngp.GPConfig(max_depth=3), **kw)
    ref = jprof.phase_report()
    ngp.reset_phases()
    ngp.make_and_fit_model(ngp.create_transformed_data(dates, y),
                           config=ngp.GPConfig(max_depth=3), device="cpu",
                           **kw)
    got = ngp.phase_report()
    assert {"smc/reweight", "smc/rejuvenate"} <= set(ref)
    assert {k: v["calls"] for k, v in got.items()} == \
        {k: v["calls"] for k, v in ref.items()}

    ngp.reset_phases()
    assert ngp.phase_report() == {}
    model = ngp.make_and_fit_model(
        ngp.create_transformed_data(dates, y), config=ngp.GPConfig(
            max_depth=3), device="cpu", **dict(kw, engine="device",
                                               n_mcmc=1, n_hmc=1))
    segments = schedule_segments(linear_schedule(len(y), 0.25), model._cap)
    assert ngp.phase_report()["smc/device_fit"]["calls"] == len(segments)

    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).cumsum(0)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("cumsum" in e.key for e in prof.key_averages())


# -------------------------------------------------------------- acceptance


def test_run_acceptance_returns_the_jax_schema():
    """``examples/acceptance.py --smoke``'s budget (40 weeks, 2 particles,
    proportion 0.34, 2 x 2 moves, 8 forecasts, 4 nowcasts) at depth 3, on
    two report dates so the default panel fit runs."""
    rev = dict(log_mean=0.25, log_sd=0.10)
    vintage = ngp.synthetic_nhsn_vintage(40, seed=0, **rev)
    rds = list(vintage.report_date_range())
    res = ngp.run_acceptance(
        vintage, report_dates=rds[24:35:10], n_forecasts=8,
        n_nowcast_samples=4, seed=0, n_particles=2,
        smc_data_proportion=0.34, n_mcmc=2, n_hmc=2,
        config=ngp.GPConfig(max_depth=3), device="cpu", **rev)
    assert set(res) == {"scores", "ratios", "per_report", "scores_wis",
                        "ratios_wis", "n_report_dates"}
    assert acceptance.APPROACHES == jacc.APPROACHES
    for key in ("scores", "ratios", "per_report", "scores_wis",
                "ratios_wis"):
        assert tuple(res[key]) == jacc.APPROACHES, key
    assert res["n_report_dates"] == 2
    for a in jacc.APPROACHES:
        assert len(res["per_report"][a]) == 2
        assert np.isfinite(res["scores"][a]) and np.isfinite(
            res["scores_wis"][a])
    assert res["ratios"]["nowcast_hmc"] == 1.0
