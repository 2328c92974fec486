"""Read the numbers that ``correct`` compares, for the program, the
control and the planted faults, on many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        [--faults stuck half]

For each seed one unit of the cell runs as in a window (a report job; or
one refresh request on the mix's model, fitted once for all seeds), and
the reference judges it:

* the program: the widest LML gap of its rows, in units of each row's
  float32 sensitivity (``lml_err``) and in nats (``lml_gap``), the PIT
  distance of its draws (``pit_ks``) and the share of HMC's rows that
  HMC moved (``hmc_moved``);
* the control: the reference in the program's place at the precision
  below the configuration's float32 with TF32 off, that is K(x, x)
  rounded to TF32, for the LMLs, with the program's guard (a row that
  cannot be factored reads -1e10) (``control_lml_err``,
  ``control_lml_gap``; the rows it rejects, ``control_rejected``, and
  its gap in nats over the rest);
* a planted fault for the draws: each draw taken as its mixture
  component's mean, the Gaussian term left out where the draw is
  produced, judged against the right mixture (``fault_pit_ks``);
* with ``--faults``, the unit run again with HMC broken where the loop's
  module binds it, and all its numbers read: ``stuck``, every HMC call
  hands back the state it was given with that state's own LMLs, as if it
  rejected every trajectory; ``half``, the second half of each call's
  rows is handed back so.

Prints one JSON line a reading, then the largest program readings and the
smallest control and fault readings.  Runs on a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def fault_draws(j: dict, n_draws: int, seed: int):
    """Draws (S, D, m) of the judged mixture's components, each at its
    component's mean: the sampler's Gaussian term left out."""
    import torch

    from benchmark.loops import common

    gen = torch.Generator(device=j["mu"].device)
    gen.manual_seed(common.seed_int(seed, 9))
    w = torch.softmax(j["log_w"], -1)
    out = []
    for s in range(w.shape[0]):
        c = torch.multinomial(w[s], n_draws, replacement=True, generator=gen)
        out.append(j["mu"][s, c])
    return torch.stack(out)


def stuck(orig):
    """``run_hmc`` that runs no trajectory: the state it is given, with
    that state's own LMLs."""
    def run_hmc(*args, **kwargs):
        return orig(*args, **dict(kwargs, n_steps=0))
    return run_hmc


def half(orig):
    """``run_hmc`` whose second half of rows is handed back unmoved."""
    import torch

    def run_hmc(*args, **kwargs):
        out = orig(*args, **kwargs)
        still = orig(*args, **dict(kwargs, n_steps=0))
        h = out[0].shape[0] // 2
        return tuple(torch.cat([a[:h], b[h:]])
                     for a, b in zip(out[:3], still[:3])) + tuple(out[3:])
    return run_hmc


FAULTS = {"stuck": stuck, "half": half}


class Reader:
    """Units of ``cell`` at any seed, each judged by the reference; the
    refresh mix's model is fitted once."""

    def __init__(self, cell: dict, device: str):
        import nowcastautogp_tpu_torch as ngp
        from benchmark.spans import Spans

        self.cell, self.device = cell, device
        self.mod = importlib.import_module(
            f"benchmark.loops.{cell['traffic']['loop']}")
        self.make = lambda seed: self.mod.Loop(cell, seed, device, ngp,
                                               Spans(False))
        self.loop = None
        if self.mod.Loop.unit == "request":
            self.loop = self.make(0)
            self.loop.setup()
            self.loop.state = self.loop.model.to_dict()

    def unit(self, seed: int, fault=None):
        """(loop, record) of one unit at ``seed``, with ``fault`` planted
        under the loop's HMC recorder."""
        loop = self.loop or self.make(seed)
        if self.loop is None:
            loop.arm()
        loop.seed = seed
        orig = loop.hmc.orig
        if fault:
            loop.hmc.orig = FAULTS[fault](orig)
        try:
            rec = loop.run(0)
        finally:
            loop.hmc.orig = orig
        if self.loop is None:
            loop.release([rec])
        else:
            loop.take(rec)
        return loop, rec


def read_seed(reader: Reader, seed: int, fault=None) -> dict:
    """One unit at ``seed`` and its readings (module docstring)."""
    import torch

    from benchmark.loops import common
    from benchmark.reference import gp, scoring

    t0 = time.perf_counter()
    loop, rec = reader.unit(seed, fault)
    device = reader.device
    if device != "cpu":
        torch.cuda.empty_cache()
    j = loop.judge(rec, device, k_round=gp.round_tf32)
    if loop.unit == "request":
        prog_lml = rec["rows"]["lml"].numpy()
        moved = rec["hmc_moved"] / prog_lml.size
    else:
        prog_lml = rec["state"]["lml"]
        moved = rec["hmc_moved"] / loop.hmc_rows()
    z_fault = fault_draws(j, j["z"].shape[1], seed)
    sens = j["ref_sens"]
    return {"seed": seed, "fault": fault,
            "lml_err": common.lml_gap(prog_lml, j["ref_lml"], sens),
            "control_lml_err": common.lml_gap(j["control_lml"], j["ref_lml"],
                                              sens),
            "lml_gap": common.lml_gap(prog_lml, j["ref_lml"]),
            "control_lml_gap": common.lml_gap(j["control_lml"],
                                              j["ref_lml"]),
            "control_rejected": int((j["control_lml"] <= -1e9).sum()),
            "control_lml_gap_finite": common.lml_gap(
                *(a[j["control_lml"] > -1e9]
                  for a in (j["control_lml"], j["ref_lml"]))),
            "pit_ks": scoring.ks_uniform(common.pit(j, j["z"])),
            "fault_pit_ks": scoring.ks_uniform(common.pit(j, z_fault)),
            "hmc_moved": moved,
            "log_crps": scoring.log_crps(rec["fc"], j["truth"]),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[], choices=list(FAULTS))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    reader = Reader(harness.load_cell(args.workload), "cuda")
    rows = []
    for seed in args.seeds:
        for fault in [None] + args.faults:
            rows.append(read_seed(reader, seed, fault))
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
    prog = [r for r in rows if r["fault"] is None]
    summary = {"workload": args.workload, "seeds": len(prog)}
    for key in ("lml_err", "lml_gap", "pit_ks"):
        summary[f"max_{key}"] = max(r[key] for r in prog)
    summary["min_hmc_moved"] = min(r["hmc_moved"] for r in prog)
    for key in ("control_lml_err", "control_lml_gap",
                "control_lml_gap_finite", "fault_pit_ks"):
        summary[f"min_{key}"] = min(r[key] for r in prog)
    summary["median_lml_err"] = float(np.median([r["lml_err"] for r in prog]))
    for fault in args.faults:
        summary[f"max_hmc_moved_{fault}"] = max(
            r["hmc_moved"] for r in rows if r["fault"] == fault)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
