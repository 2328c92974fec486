"""Hubverse-format quantile submission export.

Port of the JAX package's ``eval/submission.py``, numpy and the standard
library only and carried over whole, so the CSV bytes are the JAX
package's.
The reference's forecasts feed CDC hub pipelines (FluSight / COVID-19
Forecast Hub) that consume long-format quantile tables — the "hubverse"
schema: one row per (reference_date, horizon, location, output_type_id)
with ``output_type="quantile"``.  The reference leaves that conversion to
the user; here it ships as library code so the framework's draw matrices
(`forecast` / `forecast_with_nowcasts` output, ``(n_dates, n_draws)``) go
straight to a submittable file.

Host-side numpy + stdlib csv only; quantization reuses the FluSight grid
from :mod:`.wis`.
"""

from __future__ import annotations

import csv
import datetime as _dt

import numpy as np

from ..utils.dates import as_date_array
from .wis import FLUSIGHT_QUANTILES

__all__ = ["quantile_submission", "write_submission_csv"]


def _as_pydate(d):
    if isinstance(d, np.datetime64):
        return d.astype("datetime64[D]").astype(_dt.date)
    return d


def quantile_submission(forecasts, target_end_dates, *,
                        reference_date=None,
                        target: str = "wk inc covid hosp",
                        location: str = "US",
                        quantiles=FLUSIGHT_QUANTILES,
                        nonnegative: bool = True) -> list[dict]:
    """Long-format hubverse rows from a ``(n_dates, n_draws)`` draw matrix.

    ``horizon`` counts weeks from ``reference_date`` to each target end
    date (rounded to the nearest week); ``reference_date`` defaults to one
    week before the first target date (horizon 1 for the first row).
    Quantile values are monotone per date by construction (a single
    ``np.quantile`` call per date).  Returns a list of row dicts in the
    hubverse column order.
    """
    fc = np.asarray(forecasts, dtype=np.float64)
    dates = [_as_pydate(d) for d in as_date_array(target_end_dates)]
    assert fc.ndim == 2 and fc.shape[0] == len(dates), (
        "forecasts must be (n_dates, n_draws) matching target_end_dates")
    qs = np.sort(np.asarray(quantiles, dtype=np.float64))
    if reference_date is None:
        reference_date = dates[0] - _dt.timedelta(weeks=1)
    reference_date = _as_pydate(reference_date)

    rows = []
    for i, d in enumerate(dates):
        horizon = int(round((d - reference_date).days / 7.0))
        vals = np.quantile(fc[i], qs)
        if nonnegative:
            vals = np.maximum(vals, 0.0)
        for q, v in zip(qs, vals):
            rows.append({
                "reference_date": reference_date.isoformat(),
                "target": target,
                "horizon": horizon,
                "target_end_date": d.isoformat(),
                "location": location,
                "output_type": "quantile",
                "output_type_id": f"{q:g}",
                "value": float(v),
            })
    return rows


def write_submission_csv(rows: list[dict], path: str) -> str:
    """Write hubverse rows (from :func:`quantile_submission`) to CSV."""
    if not rows:
        raise ValueError("no rows to write")
    fields = list(rows[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    return path
