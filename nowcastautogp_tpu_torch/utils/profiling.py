"""Tracing & per-phase timing.

Port of the JAX package's ``utils/profiling.py``:

* :func:`phase` -- a context manager accumulating host wall-clock into a
  global registry, used by the SMC loop (``smc/reweight``,
  ``smc/resample``, ``smc/rejuvenate``, ``smc/device_fit``); read with
  :func:`phase_report`, reset with :func:`reset_phases`.  It does not
  synchronise the card: a phase's seconds are the host's, as in the JAX
  package, and work queued on the card inside one phase may finish in the
  next one.
* :func:`device_trace` -- ``torch.profiler`` around a block (CPU activity,
  plus CUDA activity when a card is present), written as a Chrome trace
  into ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

__all__ = ["phase", "phase_report", "reset_phases", "device_trace"]

_TIMES: dict[str, float] = collections.defaultdict(float)
_COUNTS: dict[str, int] = collections.defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall-clock time under ``name``."""
    t0 = time.perf_counter()
    try:
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
