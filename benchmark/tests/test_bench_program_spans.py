"""``program_spans.py``: a traced CPU rehearsal with the program's spans in
the run's records, without them, against a program that has no
``set_sink``, and its readings on made-up spans and device events."""

from __future__ import annotations

import gc
import json

import numpy as np
import pytest

from benchmark import harness, program_spans

from .conftest import PAIRS, tiny_cell

PROGRAM = {"api/make_and_fit_model", "smc/step", "mcmc/move", "hmc/run",
           "hmc/trajectory", "lml/grad", "lml/value", "host/readback"}


def _metric_names(pair):
    result, _ = harness.run_cell(tiny_cell(*pair), 2**31 + 11, 0.0, True,
                                 "cpu", 0.0)
    return set(result["metrics"])


@pytest.mark.parametrize("pair", PAIRS)
def test_sink_holds_the_window_and_is_cleared(pair):
    from nowcastautogp_tpu_torch.utils import profiling

    callbacks = list(gc.callbacks)
    result, compared = program_spans.run(tiny_cell(*pair), 2**31 + 11, 0.0,
                                         True, "cpu", 0.0)
    assert profiling.set_sink(None) is None
    assert gc.callbacks == callbacks
    line = json.loads(json.dumps(result))
    assert line["correct"] is True, compared
    assert set(line["metrics"]) == _metric_names(pair)
    prog = line["program"]
    assert prog["sink"] is True and prog["readings"] == {}
    names = set(prog["spans_s"])
    if pair[1] == "refresh":
        assert {"api/forecast_with_nowcasts", "nowcast/rows",
                "nowcast/refresh", "hmc/run", "lml/grad"} <= names
    else:
        assert PROGRAM <= names and {"fit", "hmc", "propose"} <= names
        assert prog["calls"]["api/make_and_fit_model"] == 1


def test_no_sink_without_the_option_or_the_program_api(monkeypatch):
    from nowcastautogp_tpu_torch.utils import profiling

    pair = PAIRS[0]
    result, _ = program_spans.run(tiny_cell(*pair), 5, 0.0, False, "cpu",
                                  0.0)
    assert not any("/" in name for name in result["program"]["spans_s"])
    monkeypatch.delattr(profiling, "set_sink")
    result, _ = program_spans.run(tiny_cell(*pair), 5, 0.0, True, "cpu",
                                  0.0)
    assert result["program"]["sink"] is False
    assert not any("/" in name for name in result["program"]["spans_s"])
    assert set(result["metrics"]) == _metric_names(pair)


def test_readings_and_idle_by_span():
    per_unit = {"host/readback": 0.5, "lml/grad": 2.0, "lml/value": 0.25,
                "hmc/run": 5.0, "nowcast/rows": 0.125,
                "nowcast/resample": 0.0625, "hmc": 5.5}
    assert program_spans.readings(per_unit, "cpu") == {}
    assert program_spans.readings(per_unit, "cuda") == {
        "readback_s": 0.5, "lml_host_s": 2.25, "hmc_self_s": 3.0,
        "nowcast_host_s": 0.1875}
    # host [0, 100] ns; the device runs 5 ns behind: kernels [0, 20],
    # [15, 30], [70, 90] on the host's axis
    records = [("lml/grad", 20, 40, 2), ("hmc/run", 10, 60, 1),
               ("host/gc", 80, 95, 1), ("fit", 5, 100, 0)]
    events = (np.array([5, 20, 75]), np.array([25, 35, 95]), 5)
    idle = program_spans.idle_by_span(records, events, 0, 100)
    # idle: [30, 70] and [90, 100]; lml/grad holds [30, 40], hmc/run
    # [40, 60], host/gc [90, 95], fit the rest of its own
    assert idle == {"none": 0.0, "lml/grad": 10.0, "hmc/run": 20.0,
                    "host/gc": 5.0, "fit": 15.0}
    assert program_spans.anchor_offset(
        100, [5, 110, 120, 300], ["a", "spin_kernel(long)",
                                  "spin_kernel(long)", "b"]) == 20
    assert program_spans.anchor_offset(100, [5], ["a"]) is None

    from benchmark.spans import Spans

    spans = Spans(True)
    spans.records.extend(records)
    assert program_spans.named_gaps(spans, events, 0, 100, k=3) == [
        ["hmc/run", 40e-9], ["fit", 10e-9]]

    # readbacks end 2 us after the copy they wait for, on a device clock
    # 1,000 ns ahead: a lag of -2 us, early and late
    backs = [("host/readback", t - 500, t, 3) for t in range(10_000,
                                                             90_000,
                                                             10_000)]
    copy_ends = [t + 1_000 - 2_000 for _, _, t, _ in backs]
    assert program_spans.readback_lag(
        backs, copy_ends, copy_ends, ["Memcpy DtoH"] * 8, 1_000, 0,
        100_000) == [-2.0, -2.0]
    assert program_spans.readback_lag(backs, [5], [6], ["k"], 0, 0,
                                      100_000) is None
