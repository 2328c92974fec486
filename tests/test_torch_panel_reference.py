"""``fit_panel`` against the plain float64 reference of ``plain_panel.py``.

The panel: S = 3 series of 20, 26 and 31 weeks at three levels, P = 4
depth-3 particles a series, the device engine (one move, one trajectory
of two leapfrogs a step) on the CPU, seed 5.  One fit, recorded once per
module: every reweight LML call, every resample draw (with the generator
state it started from), every device sweep's output, and the spans.

Tolerances.  The port computes each LML in float32 from float32 inputs;
the reference in float64.  On these short series the gap is a float32
rounding of each entry of A and y carried through the factorisation, so
it is held to ``LML_RTOL`` of the row's ``|LML| + n`` (rows the reference
cannot factor must carry the sentinel).  Everything the host computes in
float64 from the port's own LMLs (the weights, ESS, the resample
indices) is held bitwise.
"""

import datetime as dt

import numpy as np
import pytest
import torch

import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu_torch.ops.lml import DEFAULT_JITTER
from nowcastautogp_tpu_torch.parallel import panel
from nowcastautogp_tpu_torch.utils import profiling

import plain_panel as ref

torch.set_num_threads(1)

P, LENS, LEVELS, SEED = 4, (20, 26, 31), (5.0, 7.5, 2.0), 5
FIT = dict(n_particles=P, smc_data_proportion=0.2, n_mcmc=1, n_hmc=1,
           config=ngp.GPConfig(max_depth=3),
           hmc_config=ngp.HMCConfig(n_leapfrog=2), engine="device",
           device="cpu")
# float32 against float64: about 2^-24 x cond(A) x (|LML| + n), cond(A)
# ~1e2 on these rows (the worst reads 6.9e-6 of |LML| + n)
LML_RTOL = 5e-5
NEW_SPANS = ("panel/step", "panel/reweight", "panel/resample", "panel/split",
             "mcmc/device_sweep", "mcmc/device_propose",
             "mcmc/device_accept")


def _datasets(order=(0, 1, 2)):
    out = []
    for s in order:
        n = LENS[s]
        dates = [dt.date(2022, 1, 3 + s) + dt.timedelta(weeks=i)
                 for i in range(n)]
        t = np.arange(n)
        y = LEVELS[s] * (1.0 + 0.1 * np.sin(2 * np.pi * t / 26 + s)) \
            + 0.05 * np.random.default_rng(s).standard_normal(n)
        out.append(ngp.create_transformed_data(dates, y))
    return out


def _days(ds):
    return np.asarray([(d - dt.date(1970, 1, 1)).days for d in ds],
                      dtype=np.float64)


@pytest.fixture(scope="module")
def fit():
    """The recorded fit: its models, the reweight calls, the resample
    draws, the sweeps' outputs and the spans."""
    calls = {"lml": [], "resample": [], "sweep": []}
    mp = pytest.MonkeyPatch()
    lml_fn, res_fn, sweep_fn = (panel.gp_lml_batched,
                                panel.resample_indices,
                                panel.rejuvenation_sweep)

    def lml(types, params, log_noise, x, y, mask, jitter):
        out = lml_fn(types, params, log_noise, x, y, mask, jitter)
        calls["lml"].append(dict(types=types.clone(), params=params.clone(),
                                 log_noise=log_noise.clone(), x=x, y=y,
                                 mask=mask, out=out.clone()))
        return out

    def resample(rng, log_w, *a):
        state = rng.bit_generator.state
        out = res_fn(rng, log_w, *a)
        calls["resample"].append(dict(step=len(calls["lml"]) - 1,
                                      state=state, log_w=log_w.copy(),
                                      out=out))
        return out

    def sweep(types, params, log_noise, lml_in, x, y, mask, *a, **k):
        out = sweep_fn(types, params, log_noise, lml_in, x, y, mask, *a, **k)
        calls["sweep"].append(dict(step=len(calls["lml"]) - 1, mask=mask,
                                   out=tuple(o.clone() for o in out[:4])))
        return out

    mp.setattr(panel, "gp_lml_batched", lml)
    mp.setattr(panel, "resample_indices", resample)
    mp.setattr(panel, "rejuvenation_sweep", sweep)
    try:
        with profiling.recording() as rec:
            models = ngp.fit_panel(_datasets(), seed=SEED, **FIT)
    finally:
        mp.undo()
    series = []
    for d, m in zip(_datasets(), models):
        x, z, norm = ref.normalise(_days(d.ds), d.y)
        series.append(dict(x=x, z=z, norm=norm,
                           order=m.to_dict()["order"]))
    return dict(models=models, calls=calls, rec=rec, series=series)


def _close(port, want, n):
    port = np.asarray(port, dtype=np.float64)
    sentinel = want <= -1e9
    assert np.all((port <= -1e9) == sentinel)
    gap = np.abs(port - want)[~sentinel]
    tol = LML_RTOL * (np.abs(want) + n)[~sentinel]
    assert np.all(gap <= tol), (gap / tol).max()


def test_reweight_lmls_match_the_reference_at_every_step(fit):
    calls, series = fit["calls"], fit["series"]
    steps = ref.grid(max(LENS), FIT["smc_data_proportion"])
    assert len(calls["lml"]) == len(steps)
    for call, n_k in zip(calls["lml"], steps):
        counts = ref.grid_counts(n_k, max(LENS), LENS)
        assert np.array_equal(call["mask"].sum(1).numpy().reshape(3, P),
                              np.repeat(counts[:, None], P, 1))
        for s, n in enumerate(counts):
            sl = slice(s * P, (s + 1) * P)
            want = ref.masked_lml(call["types"][sl], call["params"][sl],
                                  call["log_noise"][sl], series[s]["x"],
                                  series[s]["z"], series[s]["order"], n)
            _close(call["out"][sl].numpy(), want, n)


def test_final_state_and_normalisation_per_series(fit):
    for s, (m, ser) in enumerate(zip(fit["models"], fit["series"])):
        st = m.to_dict()
        assert (st["t0"], st["t_scale"], st["y_mean"], st["y_std"]) == \
            pytest.approx(ser["norm"], rel=1e-15)
        want = ref.masked_lml(st["node_types"], st["params"],
                              st["log_noise"], ser["x"], ser["z"],
                              ser["order"], LENS[s])
        _close(st["lml"], want, LENS[s])


def test_resample_indices_and_decisions_bitwise(fit):
    """The weights rebuilt by the reference's reweight from the port's
    LMLs, then the reference's per-series ESS decisions and systematic
    indices from the generator state the port drew from: the same series
    resampled at every step, the same indices bit for bit."""
    calls = fit["calls"]
    assert calls["resample"], "the fit never resampled: no test"
    log_w = np.zeros(3 * P)
    old = np.zeros(3 * P)
    for k, call in enumerate(calls["lml"]):
        new = call["out"].numpy().astype(np.float64)
        log_w = ref.reweight(log_w, old, new)
        drawn = [r for r in calls["resample"] if r["step"] == k]
        rng = np.random.default_rng()
        if drawn:
            rng.bit_generator.state = drawn[0]["state"]
        flat, log_w_ref, low = ref.resample(rng, log_w, 3, P, 0.5)
        assert len(low) == len(drawn)
        for s, r in zip(low, drawn):
            np.testing.assert_array_equal(r["log_w"],
                                          log_w[s * P:(s + 1) * P])
            np.testing.assert_array_equal(r["out"] + s * P,
                                          flat[s * P:(s + 1) * P])
        log_w = log_w_ref
        sweep, = (c for c in calls["sweep"] if c["step"] == k)
        old = sweep["out"][3].numpy().astype(np.float64)
    for s, m in enumerate(fit["models"]):
        np.testing.assert_array_equal(m.log_weight, log_w[s * P:(s + 1) * P])


def test_a_broken_row_loses_its_weight():
    """A moveless panel whose reweight rejects one row at the last step
    (its LML at the sentinel): the reference's guarded reweight, replayed
    on the port's LMLs with its resample decisions, gives the final
    weights bit for bit, the broken row's at the sentinel's weight."""
    seen, draws = [], []
    lml_fn, res_fn = panel.gp_lml_batched, panel.resample_indices
    steps = len(ref.grid(max(LENS), FIT["smc_data_proportion"]))

    def lml(*a):
        out = lml_fn(*a).clone()
        if len(seen) == steps - 1:
            out[1] = ref.SENTINEL
        seen.append(out)
        return out

    def resample(rng, log_w, *a):
        draws.append((len(seen) - 1, rng.bit_generator.state))
        return res_fn(rng, log_w, *a)

    mp = pytest.MonkeyPatch()
    mp.setattr(panel, "gp_lml_batched", lml)
    mp.setattr(panel, "resample_indices", resample)
    try:
        models = ngp.fit_panel(_datasets(), seed=SEED,
                               **dict(FIT, n_mcmc=0, n_hmc=0))
    finally:
        mp.undo()
    log_w, old = np.zeros(3 * P), np.zeros(3 * P)
    for k, out in enumerate(seen):
        new = out.numpy().astype(np.float64)
        log_w = ref.reweight(log_w, old, new)
        mine = [d for d in draws if d[0] == k]
        rng = np.random.default_rng()
        if mine:
            rng.bit_generator.state = mine[0][1]
        flat, log_w, low = ref.resample(rng, log_w, 3, P, 0.5)
        assert len(low) == len(mine)
        old = new[flat]                     # no moves: the rows gathered
    assert 0 not in low, "the broken row's series resampled: no test"
    assert log_w[1] < -9e9
    for s, m in enumerate(models):
        np.testing.assert_array_equal(m.log_weight, log_w[s * P:(s + 1) * P])


def test_device_sweep_rows_match_the_reference_on_their_own_series(fit):
    """After every device sweep each row's LML is its new tree's and
    parameters' LML on its own series, at that step's points."""
    for call in fit["calls"]["sweep"]:
        types, params, log_noise, lml = call["out"]
        counts = call["mask"].sum(1).numpy().astype(int)
        for s, ser in enumerate(fit["series"]):
            sl = slice(s * P, (s + 1) * P)
            n = counts[s * P]
            want = ref.masked_lml(types[sl], params[sl], log_noise[sl],
                                  ser["x"], ser["z"], ser["order"], n)
            _close(lml[sl].numpy(), want, n)


def test_a_series_does_not_depend_on_the_others(fit):
    """Permute the series.  The reweight's rows of each series, moved to
    another place in the panel, give the same LMLs; and a moveless panel
    of the permuted series normalises each series as alone and holds
    each model's LMLs to the reference on its own data."""
    call = fit["calls"]["lml"][-1]
    perm = [2, 0, 1]
    rows = torch.as_tensor(np.concatenate(
        [np.arange(s * P, (s + 1) * P) for s in perm]))
    out = panel.gp_lml_batched(
        call["types"][rows], call["params"][rows], call["log_noise"][rows],
        call["x"][rows], call["y"][rows], call["mask"][rows], DEFAULT_JITTER)
    np.testing.assert_allclose(out.numpy(), call["out"][rows].numpy(),
                               rtol=1e-6, atol=1e-5)
    models = ngp.fit_panel(_datasets(perm), seed=SEED,
                           **dict(FIT, n_mcmc=0, n_hmc=0))
    for m, s in zip(models, perm):
        d = _datasets([s])[0]
        x, z, norm = ref.normalise(_days(d.ds), d.y)
        st = m.to_dict()
        assert (st["t0"], st["t_scale"], st["y_mean"], st["y_std"]) == \
            pytest.approx(norm, rel=1e-15)
        want = ref.masked_lml(st["node_types"], st["params"],
                              st["log_noise"], x, z, st["order"], LENS[s])
        _close(st["lml"], want, LENS[s])


def test_count_reaches_a_recorder_and_nothing_else():
    assert profiling.set_sink(None) is None
    profiling.count("panel/resampled_series", 3)       # no sink: nothing

    class SpansOnly:
        def span(self, name):
            return profiling._NULL

    with profiling.recording() as rec:
        profiling.count("panel/resampled_series", 2)
        profiling.count("panel/resampled_series", 1)
        profiling.set_sink(SpansOnly())
        profiling.count("panel/resampled_series", 5)   # no count: ignored
    assert dict(rec.counts) == {"panel/resampled_series": 3}
    assert profiling.set_sink(None) is None


def test_the_fit_counts_the_series_it_resampled(fit):
    assert fit["rec"].counts["panel/resampled_series"] == len(
        fit["calls"]["resample"])


def test_new_spans_nest_under_api_fit_panel(fit):
    recs = fit["rec"].records
    top, = [r for r in recs if r[0] == "api/fit_panel"]

    def inside(r, outer):
        return outer[1] <= r[1] and r[2] <= outer[2] and r[3] > outer[3]

    for name in NEW_SPANS:
        mine = [r for r in recs if r[0] == name]
        assert mine, name
        assert all(inside(r, top) for r in mine), name
    steps = [r for r in recs if r[0] == "panel/step"]
    assert len(steps) == len(fit["calls"]["lml"])
    for child, parent in (("panel/reweight", "panel/step"),
                          ("panel/resample", "panel/step"),
                          ("mcmc/device_sweep", "panel/step"),
                          ("mcmc/device_propose", "mcmc/device_sweep"),
                          ("mcmc/device_accept", "mcmc/device_sweep"),
                          ("hmc/run", "mcmc/device_sweep")):
        outer = [r for r in recs if r[0] == parent]
        for r in (r for r in recs if r[0] == child):
            assert any(inside(r, o) for o in outer), (child, parent)
    # the reweight's two reads back, every step
    reads = [r for r in recs if r[0] == "host/readback"]
    for rw in (r for r in recs if r[0] == "panel/reweight"):
        assert sum(inside(r, rw) for r in reads) == 2


def test_no_span_without_a_sink_and_no_number_changed(fit):
    """With no sink every span is the shared null context, and the fit's
    numbers are bitwise those of the recorded fit."""
    assert profiling.set_sink(None) is None
    assert all(profiling.span(n) is profiling._NULL for n in NEW_SPANS)
    models = ngp.fit_panel(_datasets(), seed=SEED, **FIT)
    for a, b in zip(models, fit["models"]):
        sa, sb = a.to_dict(), b.to_dict()
        for key in ("node_types", "params", "log_noise", "lml",
                    "log_weight"):
            np.testing.assert_array_equal(sa[key], sb[key])
