"""Run one cell of ``BENCHMARK.json`` once: set-up, the measured window,
the optional profiled replay, and the comparison with the reference.
A replay runs units of the window again under the profiler: a unit is a
function of the seed and its index, so the replay does the same work.

Everything that belongs to one cell is found by name: the configuration
``configs/<config>.json``, the traffic mix ``traffic/<traffic>.json``
(whose ``loop`` names ``loops/<loop>.py``), the cell's limits
``limits/<cell>.json`` and each per-layer metric's reader
``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import trace as tr
from .spans import Spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nowcastautogp_tpu")


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    mix, limits and the metrics it reports."""
    spec = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return {"name": name, "chips": w["chips"],
            "config": _json(BENCH / "configs" / f"{w['config']}.json"),
            "traffic": _json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": _json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"])}


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    mod_name = "benchmark.metrics." + metric.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's or JAX's,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _device_info(torch, device, chips):
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def _replay(loop, units, spans, sync, dev_info, n_rep):
    """Run the window's first ``n_rep`` units again under the profiler.
    Returns each replayed unit's device busy seconds, over the unit and
    inside each of its spans, and the breakdown; adds the traced
    window's ``busy_s`` and ``window_s`` to ``dev_info``."""
    mark = len(spans.records)
    rep_units, (ks, ke, names), offset = tr.profile(
        lambda: [loop.run(u["k"]) for u in units[:n_rep]], sync)
    ms, me = tr.merge(ks, ke)
    a, b = rep_units[0]["t"][0] + offset, rep_units[-1]["t"][1] + offset
    dev_info["busy_s"] = tr.busy_ns(ms, me, a, b) / 1e9
    dev_info["window_s"] = (b - a) / 1e9
    replay = []
    for u, w in zip(rep_units, units):
        u0, u1 = u["t"]
        busy_in = {}
        for name, s0, s1, _ in spans.records[mark:]:
            if s0 >= u0 and s1 <= u1:
                busy_in[name] = busy_in.get(name, 0.0) + tr.busy_ns(
                    ms, me, s0 + offset, s1 + offset) / 1e9
        replay.append({"busy_in": busy_in,
                       "busy_s": tr.busy_ns(ms, me, u0 + offset,
                                            u1 + offset) / 1e9,
                       "wall_s": (w["t"][1] - w["t"][0]) / 1e9, "of": w})
    gaps = sorted(tr.gaps(ms, me, a, b), key=lambda g: g[0] - g[1])[:10]
    breakdown = {
        "device_ops": tr.top_ops(ks, ke, names),
        "idle_gaps": [[spans.innermost((g0 + g1) // 2 - offset, a - offset,
                                       b - offset), (g1 - g0) / 1e9]
                      for g0, g1 in gaps]}
    print(f"trace: {len(ks)} device events, host-to-device clock offset "
          f"{offset / 1e3:.1f} us", file=sys.stderr)
    return replay, breakdown


def compare(checks: dict, limits: dict) -> dict:
    """Each compared number beside its limit: at most ``limits["checks"]``
    of it, or at least ``limits["floors"]`` of it; a number that is not
    finite never holds."""
    out = {}
    for k, v in checks.items():
        v = float(v)
        if k in limits.get("floors", {}):
            lim, op = float(limits["floors"][k]), ">="
            holds = v >= lim
        else:
            lim, op = float(limits["checks"][k]), "<="
            holds = v <= lim
        out[k] = {"value": v, "op": op, "limit": lim,
                  "holds": bool(np.isfinite(v) and holds)}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float):
    """One run of ``cell``.  Returns (result line, compared numbers);
    ``t_start`` is the process's start on ``time.perf_counter``."""
    import torch

    import nowcastautogp_tpu_torch as ngp

    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = Spans(trace, sync)
    loop_mod = importlib.import_module(
        f"benchmark.loops.{cell['traffic']['loop']}")
    loop = loop_mod.Loop(cell, seed, device, ngp, spans)
    loop.install()
    loop.setup()
    if trace and cuda:  # the profiler's first start is slow: not in a unit
        tr.profile(lambda: None, sync)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(0)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = []
    while True:
        units.append(loop.run(len(units)))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    dev_info = _device_info(torch, device, cell["chips"])

    replay, breakdown = [], None
    if trace and cuda:
        replay, breakdown = _replay(loop, units, spans, sync, dev_info,
                                    cell["traffic"]["replay_units"])
    loop.release(units)
    spans.unwrap()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed, beside = loop.check(units, device)
    print(f"beside the checks: {beside}", file=sys.stderr)
    compared = compare(checks, cell["limits"])
    correct = all(c["holds"] for c in compared.values())

    metrics = {}
    if trace:
        ctx = {"unit": loop.unit, "device": device,
               "units": [{"wall_s": (u["t"][1] - u["t"][0]) / 1e9,
                          "spans": spans.seconds(*u["t"]),
                          "work": loop.work(u)} for u in units],
               "replay": [dict(r, work=loop.work(r["of"])) for r in replay]}
        for m in cell["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        # the mix's metric, under its own name or a cell's split of it
        # ("report_s.daily"): the window over its units
        per_unit = cell["traffic"]["metric"]
        for m in cell["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"].split(".")[0] == per_unit:
                value = window_s / len(units)
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    times = [round((u["t"][1] - u["t"][0]) / 1e9, 4) for u in units]
    print(f"{loop.unit} seconds: {times}; window {window_s:.4f} s, "
          f"set-up {setup_s:.4f} s", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": len(units),
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    return result, compared
