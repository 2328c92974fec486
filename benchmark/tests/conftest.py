"""Fixtures of the benchmark's tests (``python -m pytest benchmark/tests``)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """Skip where torch sees no CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


# (configuration, traffic mix) of each cell of BENCHMARK.json
PAIRS = tuple((w["config"], w["traffic"]) for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())[
        "workloads"])


def tiny_cell(config: str, traffic: str) -> dict:
    """The cell of ``config`` under ``traffic``, with its metrics, cut to
    a size the CPU runs in a second: short series, 6 particles of depth
    3, two SMC steps."""
    from benchmark import harness

    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    name, = (w["name"] for w in spec["workloads"]
             if (w["config"], w["traffic"]) == (config, traffic))
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell["config"])
    cfg["series"].update(n_train=40, horizon=4)
    cfg["fit"].update(n_particles=6, max_depth=3, smc_data_proportion=0.5,
                      n_mcmc=1, n_hmc=1, n_leapfrog=2)
    if cfg["forecast"]["kind"] == "nowcast":
        cfg["forecast"].update(scenarios=3, draws_per_scenario=40)
    else:
        cfg["forecast"].update(draws=120)
    cell["config"] = cfg
    cell["limits"] = {"checks": {"lml_err": 50.0, "pit_ks": 0.2},
                      "floors": {"hmc_moved": 0.65},
                      "collapse_log_crps": 5.0}
    return cell
