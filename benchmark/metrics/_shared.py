"""Readings the per-layer metrics share.

``ctx`` holds the traced run's window units (``units``: each unit's
host ``wall_s``, its span seconds by name and its ``work`` count) and
the units replayed under the profiler (``replay``: each with its device
``busy_s``, its device busy seconds inside each span, ``busy_in``, and
``wall_s`` of the same unit in the window), and the ``device`` the run
used: a CPU run gives no device metric.
"""

from __future__ import annotations

from .. import costs


def span_mean(ctx, name):
    """Mean host seconds a unit spends in the spans called ``name``."""
    units = ctx["units"]
    if not units or not any(name in u["spans"] for u in units):
        return None
    return sum(u["spans"].get(name, 0.0) for u in units) / len(units)


def roofline(ctx, span):
    """Percent: the least time of the counted LML calls over the device's
    busy time inside ``span``, over the replayed units."""
    if ctx["device"] == "cpu":
        return None
    rep = ctx.get("replay") or []
    busy = sum(u["busy_in"].get(span, 0.0) for u in rep)
    if busy <= 0:
        return None
    return 100.0 * sum(u["work"]["least_s"] for u in rep) / busy


def mfu(ctx, span):
    """Percent of the peak: the counted operations over the host seconds
    of ``span``, over the window's units."""
    if ctx["device"] == "cpu":
        return None
    units = [u for u in ctx["units"] if span in u["spans"]]
    secs = sum(u["spans"][span] for u in units)
    if not units or secs <= 0:
        return None
    ops = sum(u["work"]["ops"] for u in units)
    return 100.0 * ops / secs / costs.PEAK_FLOPS


def idle(ctx):
    """Percent of a unit's wall-clock in the window with nothing on the
    device, from the same unit's device busy time in its replay."""
    if ctx["device"] == "cpu":
        return None
    rep = ctx.get("replay") or []
    wall = sum(u["wall_s"] for u in rep)
    if not rep or wall <= 0 or sum(u["busy_s"] for u in rep) <= 0:
        return None
    return 100.0 * (1.0 - sum(u["busy_s"] for u in rep) / wall)
