"""The panel cell's own pieces: the device engine's call count of a panel
fit, the 53-location generator, HMC faults planted where the device
engine binds ``run_hmc`` against the cell's own floor, and traced CPU runs
with the program's spans and counts in them, by the harness and by
``program_spans.py``."""

from __future__ import annotations

import gc
import json

import numpy as np
import pytest

from benchmark import calibrate, harness, program_spans
from benchmark.series import nhsn_panel
from benchmark.spans import Spans

from .conftest import tiny_cell


def _loop(cell):
    import nowcastautogp_tpu_torch as ngp
    from benchmark.loops import panel_report

    return panel_report.Loop(cell, 7, "cpu", ngp, Spans(False))


def test_panel_calls_are_chip_smokes_formula():
    """Weekly schedule, 14 x 5 x 5 moves: per step one value and
    1 + n_mcmc x (1 + n_hmc x n_leapfrog) gradients over all rows, 3,650
    / 10 in all (``chip_smoke.py`` phase 7's count of K1 / K2 launches),
    on the capacity segments ``fit_panel`` runs."""
    from nowcastautogp_tpu_torch.inference.schedule import linear_schedule
    from nowcastautogp_tpu_torch.inference.smc import schedule_segments

    loop = _loop(harness.load_cell("panel.report"))
    calls = loop.calls()
    assert sum(c[1] for c in calls) == 10
    assert sum(c[2] for c in calls) == 3650
    segs = schedule_segments(linear_schedule(150, 0.1), 160)
    assert [(cap, len(s), len(s) * 365) for cap, s in segs] == calls
    assert [c[0] for c in calls] == [32, 64, 96, 128, 160]
    assert loop.hmc_rows() == 10 * 14 * 53 * 24


def test_generator_levels_and_floor():
    dates, obs = nhsn_panel.generate(156, np.random.default_rng(5))
    again = nhsn_panel.generate(156, np.random.default_rng(5))[1]
    assert obs.shape == (53, 156) and len(dates) == 156
    np.testing.assert_array_equal(obs, again)
    assert obs.min() >= 1.0
    assert nhsn_panel.LEVELS[0] == 20000.0
    assert nhsn_panel.LEVELS[1:].sum() == pytest.approx(20000.0)
    assert 30 < nhsn_panel.LEVELS.min() < 40
    # the noise-free peak is the level; noise of 0.12 around it
    ratio = obs.max(1) / nhsn_panel.LEVELS
    assert np.all((ratio > 0.8) & (ratio < 1.6))


def test_traced_run_holds_the_programs_spans_and_counts(capsys):
    from nowcastautogp_tpu_torch.utils import profiling

    cell = tiny_cell("nhsn_panel_53x24", "panel_report")
    result, compared = harness.run_cell(cell, 2**31 + 11, 0.0, True, "cpu",
                                        0.0)
    assert profiling.set_sink(None) is None
    assert result["correct"] is True, compared
    assert "propose_s.panel" in result["metrics"]
    assert "panel_host_s.panel" not in result["metrics"]   # none on a CPU
    beside = capsys.readouterr().err
    assert "resampled_series_a_job" in beside


@pytest.mark.parametrize("kind", ["state_unchanged", "half_refreshed"])
def test_planted_hmc_faults_are_not_correct(monkeypatch, kind):
    """HMC broken where the device engine binds it, under the cell's own
    floor: every call hands back its input (``stuck``), or the second half
    of each call's rows, 26.5 of the 53 locations (``half``).  Either
    leaves the LMLs the program's own, so only ``hmc_moved`` can see it."""
    from nowcastautogp_tpu_torch.inference import device_smc

    plant = calibrate.stuck if kind == "state_unchanged" else calibrate.half
    monkeypatch.setattr(device_smc, "run_hmc", plant(device_smc.run_hmc))
    cell = tiny_cell("nhsn_panel_53x24", "panel_report")
    cell["limits"]["floors"] = harness.load_cell("panel.report")["limits"][
        "floors"]
    result, compared = harness.run_cell(cell, 2**31 + 7, 0.0, False, "cpu",
                                        0.0)
    assert result["correct"] is False, compared
    assert compared["hmc_moved"]["holds"] is False, compared


PANEL_SPANS = {"api/fit_panel", "panel/step", "panel/reweight",
               "panel/resample", "panel/split", "mcmc/device_sweep",
               "mcmc/device_propose", "mcmc/device_accept", "hmc/run",
               "lml/grad", "lml/value", "host/readback",
               "api/forecast_with_nowcasts"}


def test_program_spans_hold_the_panels_spans_and_are_cleared():
    """``program_spans.py`` on the panel cell, where the loop installs a
    sink of its own too: the program's panel and device-engine spans land
    in the window's records beside the benchmark's, one ``fit_panel`` a
    job, and the sink and the gc hook are gone after."""
    from nowcastautogp_tpu_torch.utils import profiling

    callbacks = list(gc.callbacks)
    result, compared = program_spans.run(
        tiny_cell("nhsn_panel_53x24", "panel_report"), 2**31 + 11, 0.0,
        True, "cpu", 0.0)
    assert profiling.set_sink(None) is None
    assert gc.callbacks == callbacks
    line = json.loads(json.dumps(result))
    assert line["correct"] is True, compared
    assert "propose_s.panel" in line["metrics"]
    prog = line["program"]
    assert prog["sink"] is True and prog["readings"] == {}
    assert PANEL_SPANS | {"fit", "forecast", "hmc"} <= set(prog["spans_s"])
    assert prog["calls"]["api/fit_panel"] == 1
