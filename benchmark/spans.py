"""Host spans recorded by the benchmark around its calls into the program.

A span is (name, start, end, depth) on the host's wall clock in
nanoseconds (``time.time_ns``, the clock the profiler's device events are
stamped in).  ``wrap`` replaces a function where a program module binds
it, so the program's own calls run inside a span; ``unwrap`` restores
every binding.  A recorder that is off records nothing and wraps nothing.
"""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self, on: bool, sync=None):
        self.on = on
        self.sync = sync
        self.records: list[tuple[str, int, int, int]] = []
        self._depth = 0
        self._patches = []

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A span around the body; ``sync`` waits for the device before
        it ends, so the span holds the device work it queued."""
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        self._depth += 1
        try:
            yield
        finally:
            if sync and self.sync is not None:
                self.sync()
            self._depth -= 1
            self.records.append((name, t0, time.time_ns(), self._depth))

    def wrap(self, module, attr: str, name: str) -> None:
        """Record a span around every call of ``module.attr``."""
        if not self.on:
            return
        orig = getattr(module, attr)

        def wrapper(*args, **kwargs):
            with self.span(name):
                return orig(*args, **kwargs)

        setattr(module, attr, wrapper)
        self._patches.append((module, attr, orig))

    def unwrap(self) -> None:
        for module, attr, orig in reversed(self._patches):
            setattr(module, attr, orig)
        self._patches.clear()

    def seconds(self, t0: int, t1: int) -> dict:
        """Total seconds by span name of the spans inside [t0, t1]."""
        out: dict[str, float] = {}
        for name, a, b, _ in self.records:
            if a >= t0 and b <= t1:
                out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def innermost(self, t: int, t0: int, t1: int) -> str:
        """The name of the deepest span open at time t, among the spans
        inside [t0, t1]; "none" where none is open."""
        best, depth = "none", -1
        for name, a, b, d in self.records:
            if a <= t < b and a >= t0 and b <= t1 and d > depth:
                best, depth = name, d
        return best
