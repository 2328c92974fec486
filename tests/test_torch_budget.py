"""The per-call memory budget (``ops/lml.py``) and its four users.

A row (a particle) of a batched call is budgeted at ``_ROW_MATRICES``
(cap, cap) float32 matrices and a call at ``_CHUNK_BYTES``
(``budget_bytes`` and ``budget_rows``).  Its users: the composed core's
particle chunks (``composed_chunk``), the panel's row check
(``parallel/panel.py::_check_rows``), the batched nowcast's scenario
chunks (``nowcast._scenario_chunk``) and the HMC graph's engagement
(``inference/hmc.py::_uses_graph``, half the budget).  Each is held at a
shape that fills its budget exactly and one row, particle or scenario
beyond it, at the defaults of 32 GiB and 8 matrices a row.

Then the batched nowcast under a budget forced down to a few scenarios:
one batched call per chunk, in order, and the budget's chunk sizes.
"""

import datetime as dt
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu_torch import nowcast
from nowcastautogp_tpu_torch.inference import hmc
from nowcastautogp_tpu_torch.ops import lml
from nowcastautogp_tpu_torch.parallel import panel

torch.set_num_threads(1)


def _scenario_chunk(P, S):
    """``_scenario_chunk`` for P particles and S scenarios at capacity 64:
    a base model of 62 points and two nowcast dates."""
    model = SimpleNamespace(num_particles=P, n_ingested=62, _cap=64)
    return nowcast._scenario_chunk(model, [SimpleNamespace(ds=[0, 0])] * S)


# (call, expected): 2^30 / cap^2 rows fill the 32 GiB at capacity cap, half
# of that the graph's 16 GiB
BOUNDARIES = {
    # one particle is the whole budget at 32,768 points
    "composed_at_32768": (lambda: lml.composed_chunk(32768), 1),
    "composed_beyond_32768": (lambda: lml.composed_chunk(32769), ValueError),
    # 64 particles are the whole budget at 4,096 points
    "composed_at_4096": (lambda: lml.composed_chunk(4096), 64),
    "composed_beyond_4096": (lambda: lml.composed_chunk(4097), 63),
    "panel_at_budget": (lambda: panel._check_rows(262144, 64), None),
    "panel_beyond_budget": (lambda: panel._check_rows(262145, 64),
                            ValueError),
    # 1,024 scenarios of 256 particles are the whole budget at 64 points
    "scenarios_at_budget": (lambda: _scenario_chunk(256, 1024), 1024),
    "scenarios_beyond_budget": (lambda: _scenario_chunk(256, 1025), 1024),
    # one scenario of 262,144 particles is; beyond it a chunk stays one
    "scenario_alone_at_budget": (lambda: _scenario_chunk(262144, 3), 1),
    "scenario_alone_beyond_budget": (lambda: _scenario_chunk(262145, 3), 1),
    "graph_at_budget": (lambda: hmc._uses_graph("cuda", 131072, 64), True),
    "graph_beyond_budget": (lambda: hmc._uses_graph("cuda", 131073, 64),
                            False),
    "graph_at_160": (lambda: hmc._uses_graph("cuda", 20971, 160), True),
    "graph_beyond_160": (lambda: hmc._uses_graph("cuda", 20972, 160), False),
}


@pytest.mark.parametrize("case", list(BOUNDARIES))
def test_budget_boundaries(case):
    call, want = BOUNDARIES[case]
    if want is ValueError:
        with pytest.raises(ValueError, match="budget"):
            call()
    else:
        got = call()
        assert got == want and type(got) is type(want), (got, want)


@pytest.fixture(scope="module")
def nowcast_model():
    n = 26
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    y = 6.5 + 0.6 * np.sin(np.arange(n) / 4.0)
    data = ngp.create_transformed_data(dates, y)
    model = ngp.make_and_fit_model(data, n_particles=2, n_mcmc=0, n_hmc=1,
                                   seed=1, config=ngp.GPConfig(max_depth=3),
                                   device="cpu")
    nc_dates = [dates[-1] + dt.timedelta(weeks=i + 1) for i in range(2)]
    ncs = ngp.create_nowcast_data(
        [np.array([6.4, 6.6]) + 0.01 * i for i in range(5)], nc_dates)
    f_dates = [nc_dates[-1] + dt.timedelta(weeks=i + 1) for i in range(2)]
    return model, ncs, f_dates


def _budget_of(monkeypatch, model, ncs, n_scenarios):
    """Force the budget of one call down to ``n_scenarios`` scenarios."""
    cap = nowcast._scenario_cap(model, ncs[0].ds)
    monkeypatch.setattr(lml, "_CHUNK_BYTES", n_scenarios * lml.budget_bytes(
        model.num_particles, cap))


@pytest.mark.parametrize("refresh", [dict(n_hmc=1), dict(forecast_n_hmc=1)],
                         ids=["n_hmc", "forecast_n_hmc"])
def test_forecast_with_nowcasts_runs_one_call_per_scenario_chunk(
        refresh, nowcast_model, monkeypatch):
    """S = 5 scenarios of 2 particles under a budget of 2 scenarios: three
    chunks of 2, 2 and 1 scenarios, each its two reweight LMLs and its
    refresh (``run_hmc``) or per-draw scan over its own rows; the draws
    are (dates, S x draws) and finite, and the base model is unchanged."""
    model, ncs, f_dates = nowcast_model
    _budget_of(monkeypatch, model, ncs, 2)
    second = "run_hmc" if "n_hmc" in refresh else "nowcast_forecast_hmc_scan"
    calls = []
    for name in ("gp_lml_batched", second):
        real = getattr(nowcast, name)
        monkeypatch.setattr(nowcast, name, lambda *a, _r=real, _n=name, **k:
                            calls.append((_n, a[0].shape[0])) or _r(*a, **k))
    before = model.to_dict()["params"].copy()
    fc = ngp.forecast_with_nowcasts(model, ncs, f_dates, 3, **refresh)
    assert fc.shape == (2, 5 * 3) and np.all(np.isfinite(fc))
    assert calls == [(name, rows) for rows in (4, 4, 2)
                     for name in ("gp_lml_batched", "gp_lml_batched",
                                  second)]
    np.testing.assert_array_equal(model.to_dict()["params"], before)


def test_nowcast_scenario_chunk_budgets_one_device(nowcast_model,
                                                   monkeypatch):
    """Budgets of 1, 4 and 6 scenarios give chunks of 1, 4 and all 5."""
    model, ncs, _ = nowcast_model
    got = []
    for n in (1, 4, 6):
        _budget_of(monkeypatch, model, ncs, n)
        got.append(nowcast._scenario_chunk(model, ncs))
    assert got == [1, 4, 5]
