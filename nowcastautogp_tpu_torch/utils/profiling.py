"""Tracing & per-phase timing: the port's one span facility.

* :func:`span` -- a context manager around one layer boundary of the fit,
  forecast, nowcast and panel paths (``api/*``, ``smc/*``, ``mcmc/*``,
  ``hmc/*``, ``lml/*``, ``nowcast/*``, ``panel/*``, ``host/*``; the table
  is in ``PERF.md`` §3).
  With no sink installed it returns one shared null context: it reads no
  clock, allocates nothing and records nothing, so the program pays one
  function call a site.  With a sink installed it returns
  ``sink.span(name)``.
* :func:`in_span` decorates a function to run inside a :func:`span`.
* :func:`count` hands a count to the sink's ``count(name, n)`` where the
  sink has one, and does nothing otherwise (``panel/resampled_series``).
* :func:`set_sink` installs a sink (any object whose ``span(name)``
  returns a context manager) and returns the previous one; ``None``
  clears it.  While a sink is installed a ``gc.callbacks`` hook records
  each garbage collection as a span ``host/gc``.
* :func:`recording` installs a :class:`Recorder` for the block and yields
  it: the operator's way to get a job's spans.  A record is
  ``(name, start_ns, end_ns, depth)`` on ``time.time_ns()``, the wall
  clock ``torch.profiler`` stamps device events in, so the spans lie on
  the device trace's axis once the two clocks' offset is known.  Spans
  take host time: none synchronises the card, so device work queued inside
  one span may run during a later one, and a span that waits on the card
  (``host/readback``, through :func:`readback`) holds that wait.
* :func:`phase` -- :func:`span` plus the JAX package's aggregate of host
  wall-clock, used by the SMC loop (``smc/reweight``, ``smc/resample``,
  ``smc/rejuvenate``, ``smc/device_fit``); read with :func:`phase_report`,
  reset with :func:`reset_phases`.
* :func:`device_trace` -- ``torch.profiler`` around a block (CPU activity,
  plus CUDA activity when a card is present), written as a Chrome trace
  into ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import os
import time

__all__ = ["span", "in_span", "count", "set_sink", "recording", "Recorder",
           "readback", "phase", "phase_report", "reset_phases",
           "device_trace"]

_NULL = contextlib.nullcontext()
_sink = None
_gc_open: list = []   # the host/gc span of the collection in progress

_TIMES: dict[str, float] = collections.defaultdict(float)
_COUNTS: dict[str, int] = collections.defaultdict(int)


def span(name: str):
    """A span called ``name`` around the body, in the installed sink; the
    shared null context when none is installed."""
    sink = _sink
    if sink is None:
        return _NULL
    return sink.span(name)


def in_span(name: str):
    """A decorator: every call of the function runs inside the span
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name`` in the installed sink, where the
    sink keeps counts; nothing otherwise."""
    add = getattr(_sink, "count", None)
    if add is not None:
        add(name, n)


def _on_gc(phase_: str, info) -> None:
    if phase_ == "start":
        if _sink is not None:
            cm = _sink.span("host/gc")
            cm.__enter__()
            _gc_open.append(cm)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def set_sink(sink):
    """Install ``sink`` (``None`` clears it); returns the previous one."""
    global _sink
    prev, _sink = _sink, sink
    if sink is not None and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    elif sink is None and _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    return prev


class Recorder:
    """A sink that keeps every span in memory, as ``records`` of
    ``(name, start_ns, end_ns, depth)`` in the order the spans end; depth
    0 is a span opened with no other open.  ``counts`` sums each count by
    name."""

    def __init__(self):
        self.records: list[tuple[str, int, int, int]] = []
        self.counts: dict[str, int] = collections.defaultdict(int)
        self._depth = 0

    def count(self, name: str, n: int) -> None:
        self.counts[name] += int(n)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.records.append((name, t0, time.time_ns(), self._depth))


@contextlib.contextmanager
def recording():
    """Record the block's spans: installs a :class:`Recorder`, yields it,
    and puts the previous sink back on exit."""
    rec = Recorder()
    prev = set_sink(rec)
    try:
        yield rec
    finally:
        set_sink(prev)


def readback(t):
    """``t.cpu().numpy()`` inside a ``host/readback`` span: the host
    blocked on the card until ``t`` is computed, plus the copy.  Every
    device-to-host read of the fit, forecast, nowcast and panel paths
    goes through here."""
    with span("host/readback"):
        return t.cpu().numpy()


@contextlib.contextmanager
def phase(name: str):
    """A :func:`span` that also accumulates its wall-clock under ``name``."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _TIMES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def phase_report() -> dict[str, dict[str, float]]:
    """{phase: {seconds, calls}} accumulated since the last reset."""
    return {
        k: {"seconds": round(_TIMES[k], 4), "calls": _COUNTS[k]}
        for k in sorted(_TIMES)
    }


def reset_phases() -> None:
    """Clear all accumulated phase timings."""
    _TIMES.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a block.

    Records CPU activity, and CUDA activity when ``torch.cuda`` has a card;
    on exit writes ``trace.json`` (Chrome trace format, viewable in
    Perfetto or ``chrome://tracing``) into ``log_dir``.  Yields the
    profiler, whose ``key_averages()`` the caller may read.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
