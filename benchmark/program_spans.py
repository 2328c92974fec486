"""Run one cell as ``run.py --trace 1`` does, with the program's own spans
recorded beside the benchmark's.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \
        --seconds <s> --sink <0|1>

With ``--sink 1`` the run's ``Spans`` is the program's span sink
(``nowcastautogp_tpu_torch.utils.profiling.set_sink``) from the loop's
install to its release, so the program's spans (``api/*``, ``smc/*``,
``mcmc/*``, ``hmc/*``, ``lml/*``, ``nowcast/*``, ``host/*``) land in the
run's records, nested in the benchmark's and on the same clock: the
breakdown's idle gaps are then named by the innermost program span.
``--sink 0`` is the plain traced run; the two give the recorder's cost.
A program without ``set_sink`` runs as with ``--sink 0``.

Prints the harness's result line with one more entry, ``program``: each
span's mean seconds and calls a unit over the window and the five
longest of each program span; on a card, the readings the program's
spans give (``readings``), and for the replayed units the device-idle
seconds by the innermost span open at the time (``idle_by_span``, a
unit's mean) and the ten longest idle gaps, each named by the innermost
span at its middle (``idle_gaps``).  These put the spans on the device's
axis by an anchor of this script's own, a ``spin_kernel`` launched at a
known host time at the end of the profiled block; ``offset_us`` gives it
beside the harness's, whose anchor opens the block, where the tracer can
miss the first launches (the harness then takes a later kernel for its
anchor and its offset is that much too large), and ``readback_lag_us``
checks each offset early and late in the replay against the
device-to-host copies the readbacks wait for.  The cell's metrics,
checks and breakdown are the harness's own.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

# reading: [spans added, spans taken away], seconds a unit
READINGS = {
    "readback_s": (["host/readback"], []),
    "lml_host_s": (["lml/value", "lml/grad"], []),
    "hmc_self_s": (["hmc/run"], ["lml/grad"]),
    "nowcast_host_s": (["nowcast/rows", "nowcast/resample",
                        "nowcast/priors"], []),
    "gc_s": (["host/gc"], []),
}


def readings(per_unit: dict, device: str) -> dict:
    """The readings of ``READINGS`` from each span's mean seconds a unit;
    none on a CPU run, where a readback is free and an LML call's host
    time is its whole computation, nor where no added span fired."""
    if device == "cpu":
        return {}
    out = {}
    for name, (plus, minus) in READINGS.items():
        if any(s in per_unit for s in plus):
            out[name] = (sum(per_unit.get(s, 0.0) for s in plus)
                         - sum(per_unit.get(s, 0.0) for s in minus))
    return out


def idle_by_span(records, events, t0: int, t1: int) -> dict:
    """Device-idle nanoseconds inside host [t0, t1] by the innermost span
    open at the time ("none" where none is): each span's idle time less
    its children's.  ``events`` is the profiler's (starts, ends, offset);
    ``records`` are properly nested spans on the host clock."""
    import numpy as np

    from . import trace as tr

    ks, ke, offset = events
    ms, me = tr.merge(ks, ke)
    cum = np.r_[0, np.cumsum(me - ms)]

    def busy_before(t):          # device busy ns before host times t
        t = np.asarray(t, dtype=np.int64) + offset
        k = np.searchsorted(ms, t, side="right") - 1
        inside = np.clip(t - ms[np.maximum(k, 0)], 0,
                         (me - ms)[np.maximum(k, 0)])
        return np.where(k >= 0, cum[np.maximum(k, 0)] + inside, 0)

    recs = sorted((r for r in records if r[1] >= t0 and r[2] <= t1),
                  key=lambda r: (r[1], -r[2]))
    a = np.array([r[1] for r in recs], dtype=np.int64)
    b = np.array([r[2] for r in recs], dtype=np.int64)
    idle = (b - a) - (busy_before(b) - busy_before(a))
    own = idle.astype(float)
    top = float((t1 - t0) - (busy_before(t1) - busy_before(t0)))
    stack: list[int] = []
    for i in range(len(recs)):
        while stack and b[stack[-1]] <= a[i]:
            stack.pop()
        if stack:
            own[stack[-1]] -= idle[i]
        else:
            top -= idle[i]
        stack.append(i)
    out = {"none": top}
    for r, v in zip(recs, own):
        out[r[0]] = out.get(r[0], 0.0) + float(v)
    return out


def anchor_offset(stamp: int, starts, names):
    """The host-to-device clock offset from the last ``spin_kernel``
    among the profiled events, launched right after the host time
    ``stamp`` (taken after a synchronise); None where there is none."""
    spins = [s for s, n in zip(starts, names) if "spin_kernel" in n]
    return int(spins[-1]) - stamp if spins else None


def readback_lag(records, starts, ends, names, offset, t0: int, t1: int):
    """How well ``offset`` puts the spans on the device's axis, early and
    late in host [t0, t1]: a ``host/readback`` returns just after its
    device-to-host copy ends, so the copy's end less the span's, each on
    the device's axis, is a few microseconds below zero where the offset
    holds.  The median over the first and over the last quarter of the
    readbacks, microseconds, against the copy that ends nearest; None
    without readbacks or copies."""
    import numpy as np

    copies = np.sort(np.asarray([e for e, n in zip(ends, names)
                                 if "DtoH" in n], dtype=np.int64))
    backs = sorted(b for name, a, b, _ in records
                   if name == "host/readback" and t0 <= a and b <= t1)
    if copies.size == 0 or len(backs) < 4:
        return None
    at = np.asarray(backs, dtype=np.int64) + offset
    i = np.clip(np.searchsorted(copies, at), 1, copies.size - 1)
    near = np.where(at - copies[i - 1] <= copies[i] - at, copies[i - 1],
                    copies[i])
    lag = (near - at) / 1e3
    q = len(lag) // 4
    return [float(np.median(lag[:q])), float(np.median(lag[-q:]))]


def named_gaps(spans, events, t0: int, t1: int, k: int = 10):
    """The ``k`` longest device-idle gaps inside host [t0, t1], each
    named by the innermost span open at its middle, with its seconds."""
    from . import trace as tr

    ks, ke, offset = events
    ms, me = tr.merge(ks, ke)
    gaps = sorted(tr.gaps(ms, me, t0 + offset, t1 + offset),
                  key=lambda g: g[0] - g[1])[:k]
    return [[spans.innermost((g0 + g1) // 2 - offset, t0, t1),
             (g1 - g0) / 1e9] for g0, g1 in gaps]


def run(cell: dict, seed: int, seconds: float, sink: bool, device: str,
        t_start: float):
    """``harness.run_cell`` of ``cell`` with ``trace`` on, the program's
    spans in the run's records where ``sink``; returns the result line
    with ``program`` added, and the compared numbers."""
    from nowcastautogp_tpu_torch.utils import profiling

    from . import harness
    from . import trace as tr

    set_sink = getattr(profiling, "set_sink", None) if sink else None
    loop_cls = importlib.import_module(
        f"benchmark.loops.{cell['traffic']['loop']}").Loop
    install, release, profile = loop_cls.install, loop_cls.release, (
        tr.profile)
    seen: dict = {}

    def installed(self):
        install(self)
        seen["spans"] = self.spans
        if set_sink is not None:
            set_sink(self.spans)

    def released(self, units):
        if set_sink is not None:
            set_sink(None)
        seen["t"] = [u["t"] for u in units]
        release(self, units)

    def profiled(fn, sync):
        import torch

        def anchored():
            # after the block, when the tracer is surely recording: the
            # first milliseconds of a profiler run can go unrecorded
            out = fn()
            sync()
            seen["stamp"] = time.time_ns()
            torch.cuda._sleep(1000)
            sync()
            return out

        out = profile(anchored, sync)
        if out[0]:     # the replay, not the profiler's first start
            ks, ke, names = out[1]
            seen["replay"] = ([u["t"] for u in out[0]], (ks, ke, names),
                              out[2], anchor_offset(seen["stamp"], ks,
                                                    names))
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(loop_cls, "install",
                                              installed))
        stack.enter_context(mock.patch.object(loop_cls, "release",
                                              released))
        stack.enter_context(mock.patch.object(tr, "profile", profiled))
        try:
            result, compared = harness.run_cell(cell, seed, seconds, True,
                                                device, t_start)
        finally:
            if set_sink is not None:
                set_sink(None)
    spans = seen["spans"]
    n = len(seen["t"])
    per_unit: dict = {}
    calls: dict = {}
    for t0, t1 in seen["t"]:
        for name, s in spans.seconds(t0, t1).items():
            per_unit[name] = per_unit.get(name, 0.0) + s / n
        for name, a, b, _ in spans.records:
            if a >= t0 and b <= t1:
                calls[name] = calls.get(name, 0) + 1
    program = {"sink": set_sink is not None,
               "spans_s": dict(sorted(per_unit.items())),
               "calls": {k: v / n for k, v in sorted(calls.items())},
               "readings": readings(per_unit, device)}
    program["longest_ms"] = {}
    for name, a, b, _ in spans.records:
        if "/" in name and any(t0 <= a and b <= t1 for t0, t1 in seen["t"]):
            top = program["longest_ms"].setdefault(name, [])
            top.append((b - a) / 1e6)
            top.sort(reverse=True)
            del top[5:]
    if "replay" in seen:
        times, (ks, ke, names), harness_off, anchor_off = seen["replay"]
        program["offset_us"] = {"harness": harness_off / 1e3,
                                "anchor": (None if anchor_off is None
                                           else anchor_off / 1e3)}
        # the spans on the device's axis by the anchor where it was found
        events = (ks, ke, harness_off if anchor_off is None else anchor_off)
        idle: dict = {}
        for t0, t1 in times:
            for name, ns in idle_by_span(spans.records, events, t0,
                                         t1).items():
                idle[name] = idle.get(name, 0.0) + ns / 1e9 / len(times)
        program["idle_by_span"] = dict(sorted(idle.items(),
                                              key=lambda kv: -kv[1]))
        program["idle_gaps"] = named_gaps(spans, events, times[0][0],
                                          times[-1][1])
        offsets = {"harness": harness_off, "anchor": anchor_off}
        program["readback_lag_us"] = {
            k: readback_lag(spans.records, ks, ke, names, off,
                            times[0][0], times[-1][1])
            for k, off in offsets.items() if off is not None}
    result["program"] = program
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sink", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    # run.py's process: one host thread for every library
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"program_spans: the cell needs {cell['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from benchmark import program_spans

    result, compared = program_spans.run(cell, args.seed, args.seconds,
                                         bool(args.sink), "cuda", T_START)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} {c['op']} limit "
              f"{c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
