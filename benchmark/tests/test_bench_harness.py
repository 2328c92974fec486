"""Harness hygiene: what the benchmark imports, a CPU rehearsal of each
traffic loop, the refusal without a card, readers that find nothing,
planted faults that ``correct`` must catch, and BENCHMARK.json's form."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

from .conftest import PAIRS, tiny_cell

BENCH = Path(harness.__file__).resolve().parent


def _top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        names = _top_imports(f)
        assert not names & {"jax", "jaxlib", "flax", "nowcastautogp_tpu"}, f
        if "reference" in f.relative_to(BENCH).parts:
            assert "nowcastautogp_tpu_torch" not in names, f
            assert names <= {"__future__", "math", "datetime", "numpy",
                             "torch"}, f


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("pair", PAIRS)
def test_cpu_rehearsal_of_each_loop(pair, trace):
    result, compared = harness.run_cell(tiny_cell(*pair), 2**31 + 11, 0.0,
                                        trace, "cpu", 0.0)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, compared
    assert line["attempted"] == 1 and line["failed"] == 0
    cell = tiny_cell(*pair)
    if trace:
        spans = {"fit_s", "forecast_s", "hmc_host_s", "propose_s"}
        assert set(line["metrics"]) == {
            m["name"] for m in cell["per_layer"]
            if m["name"].split(".")[0] in spans}
    else:
        assert set(line["metrics"]) == {m["name"]
                                        for m in cell["end_to_end"]}
        assert len(line["metrics"]) == 2


def test_run_exits_without_a_card():
    """A cell of BENCHMARK.json, where torch sees no card: exit 2, say
    so, print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "daily.report",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 2, proc.stderr
    assert "the cell needs 1 CUDA card(s)" in proc.stderr
    assert proc.stdout == ""


def test_readers_give_none_where_no_span_fired():
    ctx = {"unit": "job", "device": "cuda",
           "units": [{"wall_s": 1.0, "spans": {}, "work": {
               "ops": 1.0, "least_s": 1.0, "bytes": 1.0}}],
           "replay": []}
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert harness.reader(m["name"])(ctx) is None, m["name"]


def _faults(monkeypatch, kind):
    import nowcastautogp_tpu_torch as ngp
    from benchmark import calibrate
    from nowcastautogp_tpu_torch import nowcast
    from nowcastautogp_tpu_torch.inference import hmc, structure_mcmc
    from nowcastautogp_tpu_torch.models import gp_model

    if kind in ("state_unchanged", "half_refreshed"):
        # HMC hands back the state it was given with that state's own
        # LMLs: on every row, or on the second half of the rows
        plant = calibrate.stuck if kind == "state_unchanged" else (
            calibrate.half)
        for mod in (structure_mcmc, nowcast):
            monkeypatch.setattr(mod, "run_hmc", plant(mod.run_hmc))
    elif kind == "half_batch":
        for mod in (structure_mcmc, hmc, gp_model, nowcast):
            orig = mod.gp_lml_batched

            def half(*a, _orig=orig, **k):
                v = _orig(*a, **k)
                h = v.shape[0] // 2
                return torch_cat(v[:h], v[:h].mean().expand(v.shape[0] - h))
            monkeypatch.setattr(mod, "gp_lml_batched", half)
    elif kind == "answer_altered":
        for name in ("forecast", "forecast_with_nowcasts"):
            orig = getattr(ngp, name)
            monkeypatch.setattr(
                ngp, name, lambda *a, _orig=orig, **k: 1.5 * _orig(*a, **k))


def torch_cat(a, b):
    import torch

    return torch.cat([a, b])


@pytest.mark.parametrize("kind", ["state_unchanged", "half_refreshed",
                                  "half_batch", "answer_altered"])
@pytest.mark.parametrize("pair", PAIRS)
def test_planted_faults_are_not_correct(monkeypatch, pair, kind):
    _faults(monkeypatch, kind)
    result, compared = harness.run_cell(tiny_cell(*pair), 7, 0.0, False,
                                        "cpu", 0.0)
    assert result["correct"] is False, compared


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_form():
    root = BENCH.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    rs = spec["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and c["reduced"] == []
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types

    assert not any(m.split(".")[0] == "nowcastautogp_tpu"
                   for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "nowcastautogp_tpu_torch_x",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "nowcastautogp_tpu.ops",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax.numpy",
                                           "nowcastautogp_tpu.ops"]


def test_replay_reads_busy_time_gaps_and_spans(monkeypatch):
    """The replay's arithmetic on made-up device events: a unit of
    [0, 100] ns with a span "hmc" over [10, 60] and kernels [0, 20],
    [15, 30] and [70, 90] on the device clock, 5 ns behind the host's."""
    import numpy as np

    from benchmark import trace
    from benchmark.spans import Spans

    spans = Spans(True)

    class Loop:
        def run(self, k):
            spans.records.append(("hmc", 10, 60, 1))
            return {"k": k, "t": (0, 100)}

    def profile(fn, sync):
        return (fn(), (np.array([5, 20, 75]), np.array([25, 35, 95]),
                       ["a", "b", "a"]), 5)

    monkeypatch.setattr(trace, "profile", profile)
    info = {}
    replay, breakdown = harness._replay(Loop(), [{"k": 0, "t": (0, 50)}],
                                        spans, None, info, 1)
    assert info == {"busy_s": 50e-9, "window_s": 100e-9}
    assert replay[0]["busy_s"] == 50e-9 and replay[0]["wall_s"] == 50e-9
    assert replay[0]["busy_in"] == {"hmc": 20e-9}
    assert breakdown["device_ops"] == [["a", 40e-9], ["b", 15e-9]]
    assert breakdown["idle_gaps"] == [["hmc", 40e-9], ["none", 10e-9]]
