"""Device intervals from ``torch.profiler`` and what the readers need.

The profiler records device activity only (CUDA); its events are read
from the raw results (``kineto_results.events()``), which is far faster
than building the per-op event tree for the few hundred thousand kernels
of a fit.  Device timestamps are in the wall clock's nanoseconds; an
anchor (a synchronised host time, then one launch) measures the offset
between the two clocks, and host spans are moved onto the device's axis
by it.  The anchor runs twice: the profiler's first launch in a session
can wait tens of milliseconds for the tracer, and only the second one
measures the clocks.  Nothing is written to disk.
"""

from __future__ import annotations

import time

import numpy as np


def profile(fn, sync):
    """Run ``fn`` under the profiler; returns (result, device events as
    (starts ns, ends ns, names), host-to-device clock offset ns)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    anchor = torch.zeros(1, device="cuda")
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            sync()
            t_anchor = time.time_ns()
            anchor.add_(1.0)
            sync()
        result = fn()
        sync()
    starts, ends, names = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns()
        starts.append(s)
        ends.append(s + e.duration_ns())
        names.append(e.name())
    order = np.argsort(starts, kind="stable")
    starts = np.asarray(starts, dtype=np.int64)[order]
    ends = np.asarray(ends, dtype=np.int64)[order]
    names = [names[i] for i in order]
    offset = int(starts[1] - t_anchor) if starts.size > 1 else 0
    keep = slice(2, None)
    return result, (starts[keep], ends[keep], names[2:]), offset


def merge(starts, ends):
    """The union of intervals as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    run_end = np.maximum.accumulate(ends)
    new = np.ones(starts.size, dtype=bool)
    new[1:] = starts[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return starts[idx], run_end[np.r_[idx[1:] - 1, starts.size - 1]]


def busy_ns(ms, me, a, b) -> int:
    """Nanoseconds of the merged intervals inside [a, b]."""
    s = np.clip(ms, a, b)
    e = np.clip(me, a, b)
    return int(np.sum(e - s))


def gaps(ms, me, a, b):
    """Idle gaps [(start, end), ...] between merged intervals inside
    [a, b], the leading and trailing ones included."""
    inside = (me > a) & (ms < b)
    s, e = ms[inside], me[inside]
    edges_s = np.r_[a, np.minimum(e, b)]
    edges_e = np.r_[np.maximum(s, a), b]
    keep = edges_e > edges_s
    return list(zip(edges_s[keep].tolist(), edges_e[keep].tolist()))


def top_ops(starts, ends, names, k=10):
    """The k device operations by total time: [[name, seconds], ...]."""
    tot: dict[str, int] = {}
    for n, d in zip(names, (ends - starts).tolist()):
        tot[n] = tot.get(n, 0) + d
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:120], d / 1e9] for n, d in rows]
