"""Vintaged surveillance data: revision-aware containers for nowcasting.

Port of the JAX package's ``utils/data.py``, numpy only and carried over
whole, so snapshots are bitwise the JAX package's.  The reference's
getting-started vignette hand-rolls this workflow
(``docs/vignettes/getting-started.jl:149-161,377-391``): a
long-format table of ``(reference_date, report_date, value)`` where each
report date provides a *snapshot* of the series as known at that time, the
most recent reference dates are still being revised, and the fit uses
confirmed data only.  This module ships that plumbing as library code.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime as _dt

import numpy as np

from .dates import as_date_array, dates_to_float

__all__ = ["VintagedData", "load_vintaged_csv"]


@dataclasses.dataclass
class VintagedData:
    """Long-format vintaged observations.

    reference_dates / report_dates: 1-D date-like arrays (same length);
    values: observed value for ``reference_date`` as known at
    ``report_date``.
    """

    reference_dates: np.ndarray
    report_dates: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        self.reference_dates = as_date_array(self.reference_dates)
        self.report_dates = as_date_array(self.report_dates)
        self.values = np.asarray(self.values, dtype=np.float64)
        assert len(self.reference_dates) == len(self.report_dates) == len(
            self.values
        ), "columns must have equal length"

    def snapshot(self, report_date):
        """Series as known at ``report_date``: the latest value of each
        reference date among reports <= report_date.

        Returns ``(reference_dates, values)`` sorted by reference date.
        """
        rep = dates_to_float(self.report_dates)
        cutoff = dates_to_float([report_date])[0]
        sel = rep <= cutoff
        refs = self.reference_dates[sel]
        reps = rep[sel]
        vals = self.values[sel]
        ref_keys = dates_to_float(refs)
        out: dict[float, tuple[float, float, object]] = {}
        for rk, rp, v, rd in zip(ref_keys, reps, vals, refs):
            cur = out.get(rk)
            if cur is None or rp >= cur[0]:
                out[rk] = (rp, v, rd)
        keys = sorted(out)
        dates = [out[k][2] for k in keys]
        values = np.asarray([out[k][1] for k in keys])
        return as_date_array(dates), values

    def confirmed(self, report_date, n_redact: int = 1):
        """Snapshot at ``report_date`` with the last ``n_redact`` (still
        provisional) reference dates removed — the vignette's fit input
        (``docs/vignettes/getting-started.jl:281-284``)."""
        ds, vals = self.snapshot(report_date)
        if n_redact > 0:
            ds, vals = ds[:-n_redact], vals[:-n_redact]
        return ds, vals

    def provisional(self, report_date, n_last: int = 1):
        """The last ``n_last`` (still-being-revised) points of the snapshot —
        the raw material for nowcast imputation draws."""
        ds, vals = self.snapshot(report_date)
        return ds[-n_last:], vals[-n_last:]

    def final(self, reference_dates):
        """Latest-known value for each requested reference date."""
        # rows are kept in input order (not necessarily sorted by report
        # date); the latest report is the max, not the last row
        rep = dates_to_float(self.report_dates)
        ds, vals = self.snapshot(self.report_dates[int(rep.argmax())])
        key = {k: v for k, v in zip(dates_to_float(ds), vals)}
        want = dates_to_float(as_date_array(list(reference_dates)))
        return np.asarray([key[k] for k in want])

    def report_date_range(self):
        rep = dates_to_float(self.report_dates)
        order = np.argsort(rep)
        uniq = []
        seen = set()
        for i in order:
            k = rep[i]
            if k not in seen:
                seen.add(k)
                uniq.append(self.report_dates[i])
        return as_date_array(uniq)


def load_vintaged_csv(path: str, *, reference_col: str = "reference_date",
                      report_col: str = "report_date",
                      value_col: str = "confirm") -> VintagedData:
    """Load a long-format vintaged CSV (the NHSN-style layout the reference's
    vignette consumes)."""
    refs, reps, vals = [], [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            refs.append(_dt.date.fromisoformat(row[reference_col].strip()))
            reps.append(_dt.date.fromisoformat(row[report_col].strip()))
            vals.append(float(row[value_col]))
    return VintagedData(refs, reps, vals)
