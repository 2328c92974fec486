"""The control and the planted faults of ``correct``: the reference in the
program's place one precision down (K(x, x) in TF32) must read an LML gap
far above the program's, draws left at their components' means a PIT
distance far above the program's, and HMC that hands back the state it
was given a share of moved rows under the floor.

On the CPU at a small size; on the card (marker ``cuda``) at each cell's
own size on one seed, against the cell's limits.
"""

from __future__ import annotations

import json

import pytest

from benchmark import calibrate, harness

from .conftest import PAIRS, tiny_cell

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("pair", PAIRS)
def test_control_and_fault_separate_at_a_small_size(pair):
    cell = tiny_cell(*pair)
    reader = calibrate.Reader(cell, "cpu")
    r = calibrate.read_seed(reader, 424242)
    assert r["control_lml_err"] > 100 * r["lml_err"], r
    assert r["fault_pit_ks"] > 3 * r["pit_ks"], r
    floor = cell["limits"]["floors"]["hmc_moved"]
    stuck = calibrate.read_seed(reader, 424242, "stuck")
    assert stuck["hmc_moved"] == 0.0 < floor <= r["hmc_moved"], (r, stuck)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_at_the_cell_size(card, name):
    cell = harness.load_cell(name)
    lim, floor = cell["limits"]["checks"], cell["limits"]["floors"]
    reader = calibrate.Reader(cell, "cuda")
    r = calibrate.read_seed(reader, 20261017)
    assert r["lml_err"] <= lim["lml_err"] < r["control_lml_err"], r
    assert r["pit_ks"] <= lim["pit_ks"] < r["fault_pit_ks"], r
    stuck = calibrate.read_seed(reader, 20261017, "stuck")
    assert stuck["hmc_moved"] < floor["hmc_moved"] <= r["hmc_moved"], (
        r, stuck)
