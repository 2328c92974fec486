"""The port's spans (``utils/profiling.py``), on the CPU at tiny sizes.

* A host fit (4 particles, depth 3, one move, one trajectory a move) under
  ``recording()`` records each layer's span inside the one that called
  it: every ``lml/grad`` lies inside ``hmc/run`` inside ``mcmc/move``
  inside ``smc/rejuvenate`` inside ``smc/step`` inside
  ``api/make_and_fit_model``, and inside ``hmc/trajectory`` too, but for
  each call's initial evaluation.  The gradient count is the algorithm's,
  and every record lies on ``time.time_ns`` within the block.
* Spans change no number: the fitted state and the nowcast draws are
  bitwise those of the same calls without a recorder.
* The batched nowcast refresh records each of its stages and its reads
  back from the device.
* With no sink nothing is recorded and ``span`` hands out one shared null
  context; ``recording()`` puts ``gc.callbacks`` back as it found them.
"""

import datetime as dt
import gc
import time

import numpy as np
import pytest
import torch

import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu_torch.models.config import HMCConfig
from nowcastautogp_tpu_torch.utils import profiling

torch.set_num_threads(1)

N, H = 20, 2
FIT = dict(n_particles=4, smc_data_proportion=0.3, n_mcmc=1, n_hmc=1,
           config=ngp.GPConfig(max_depth=3), seed=2, device="cpu")
CHAIN = ["hmc/run", "mcmc/move", "smc/rejuvenate", "smc/step",
         "api/make_and_fit_model"]
NOWCAST_STAGES = {"nowcast/rows", "nowcast/reweight", "nowcast/resample",
                  "nowcast/priors", "nowcast/refresh", "nowcast/draws"}


def _series():
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i)
             for i in range(N + 2 * H)]
    t = np.arange(N + 2 * H)
    y = 6.5 + 0.6 * np.sin(2 * np.pi * t / 26 + 1.0) \
        + 0.12 * np.random.default_rng(0).standard_normal(N + 2 * H)
    return dates, y


def _fit():
    dates, y = _series()
    return ngp.make_and_fit_model(
        ngp.create_transformed_data(dates[:N], y[:N]), **FIT)


def _nowcast(model, **kw):
    dates, y = _series()
    ncs = ngp.create_nowcast_data([y[N:N + H] * f for f in (0.9, 1.0, 1.1)],
                                  dates[N:N + H])
    return ngp.forecast_with_nowcasts(model, ncs, dates[N + H:], 3,
                                      draw_seed=7, **kw)


def _parents(records):
    """Each record's enclosing record (one level up), or None."""
    out = []
    for name, a, b, d in records:
        up = [r for r in records
              if r[3] == d - 1 and r[1] <= a and b <= r[2]]
        out.append(max(up, key=lambda r: r[1]) if up else None)
    return out


def _chain(records, parents, i):
    names = []
    p = parents[i]
    while p is not None:
        names.append(p[0])
        p = parents[records.index(p)]
    return names


@pytest.fixture(scope="module")
def traced_fit():
    t0 = time.time_ns()
    with ngp.recording() as rec:
        model = _fit()
    return model, rec.records, t0, time.time_ns()


def test_fit_spans_nest_by_layer(traced_fit):
    _, records, t0, t1 = traced_fit
    assert all(t0 <= a <= b <= t1 for _, a, b, _ in records)
    names = {r[0] for r in records}
    assert {"api/make_and_fit_model", "smc/step", "smc/reweight",
            "smc/rejuvenate", "mcmc/move", "mcmc/propose", "mcmc/accept",
            "hmc/run", "hmc/trajectory", "lml/grad", "lml/value",
            "host/readback"} <= names
    parents = _parents(records)
    grads = [i for i, r in enumerate(records) if r[0] == "lml/grad"]
    initial = 0
    for i in grads:
        chain = _chain(records, parents, i)
        if chain[0] == "hmc/trajectory":
            chain = chain[1:]
        else:
            initial += 1
        assert chain == CHAIN, chain
    for i, r in enumerate(records):
        if r[0] in ("mcmc/propose", "mcmc/accept"):
            assert _chain(records, parents, i)[:2] == ["mcmc/move",
                                                       "smc/rejuvenate"]
        if r[0] == "smc/step":
            assert _chain(records, parents, i) == ["api/make_and_fit_model"]
    # the counts are the algorithm's: one initial evaluation a run_hmc
    # call, then n_leapfrog a trajectory
    runs = sum(r[0] == "hmc/run" for r in records)
    steps = sum(r[0] == "smc/step" for r in records)
    trajectories = sum(r[0] == "hmc/trajectory" for r in records)
    assert runs == steps * FIT["n_mcmc"] and runs > 1
    assert trajectories == runs * FIT["n_hmc"]
    assert initial == runs
    assert len(grads) == runs * (1 + FIT["n_hmc"] * HMCConfig().n_leapfrog)


def test_spans_change_no_number(traced_fit):
    traced = traced_fit[0].to_dict()
    plain_model = _fit()
    plain = plain_model.to_dict()
    for key in ("node_types", "params", "log_noise", "lml", "log_weight",
                "hmc_eps_scale", "generator_state"):
        np.testing.assert_array_equal(traced[key], plain[key], err_msg=key)
    for kw in (dict(n_hmc=1, ess_threshold=1.0), dict(forecast_n_hmc=1),
               {}):
        with ngp.recording() as rec:
            a = _nowcast(plain_model, **kw)
        assert rec.records
        np.testing.assert_array_equal(a, _nowcast(plain_model, **kw))


def test_batched_refresh_records_each_stage(traced_fit):
    model = traced_fit[0]
    with ngp.recording() as rec:
        _nowcast(model, n_hmc=1, ess_threshold=1.0)
    records = rec.records
    parents = _parents(records)
    stages = {}
    for i, r in enumerate(records):
        if r[0].startswith("nowcast/"):
            assert _chain(records, parents, i) == [
                "api/forecast_with_nowcasts"]
            stages[r[0]] = stages.get(r[0], 0) + 1
    assert set(stages) == NOWCAST_STAGES
    # the tiled rows' x and y, the two reweight LMLs, the draws
    reads = [_chain(records, parents, i)[0]
             for i, r in enumerate(records) if r[0] == "host/readback"]
    assert sorted(reads) == ["nowcast/draws", "nowcast/reweight",
                             "nowcast/reweight", "nowcast/rows",
                             "nowcast/rows"]
    with ngp.recording() as rec:
        _nowcast(model, forecast_n_hmc=1)
    assert {"nowcast/priors", "nowcast/draws", "lml/grad"} <= {
        r[0] for r in rec.records}


def test_no_sink_records_nothing():
    callbacks = list(gc.callbacks)
    assert profiling.set_sink(None) is None
    assert profiling.span("a") is profiling.span("b")
    with ngp.recording() as outer:
        with profiling.span("outer/a"):
            with ngp.recording() as inner:
                gc.collect()
                with profiling.span("inner/a"):
                    pass
        with profiling.phase("test/phase"):
            pass
    assert gc.callbacks == callbacks
    n_inner, n_outer = len(inner.records), len(outer.records)
    with profiling.span("after/a"):
        gc.collect()
    assert (len(inner.records), len(outer.records)) == (n_inner, n_outer)
    # a collection may also start by itself while a sink is installed
    assert inner.records[0][0] == "host/gc"
    assert [r[0] for r in inner.records if r[0] != "host/gc"] == ["inner/a"]
    assert [(r[0], r[3]) for r in outer.records if r[0] != "host/gc"] == [
        ("outer/a", 0), ("test/phase", 0)]
    assert profiling.phase_report()["test/phase"]["calls"] == 1
    profiling.reset_phases()
    x = torch.arange(4.0)
    np.testing.assert_array_equal(profiling.readback(x), x.numpy())
