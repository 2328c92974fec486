"""SMC data-ingestion schedules.

Equivalent of ``AutoGP.Schedule.linear_schedule`` as used by the reference's
fit wrapper (``src/make_and_fit_model.jl:89-90``): anneal in
*data size*, ingesting ``proportion x n`` observations per SMC step, always
ending exactly at ``n``.
"""

from __future__ import annotations

__all__ = ["linear_schedule"]


def linear_schedule(n: int, proportion: float) -> list[int]:
    """Cumulative observation counts per SMC step."""
    if n <= 0:
        return []
    step = max(1, int(round(proportion * n)))
    points = list(range(step, n + 1, step))
    if not points or points[-1] != n:
        points.append(n)
    return points
