"""Date-axis utilities.

The reference (CDCgov/NowcastAutoGP) carries a ``Vector{Date}`` time axis through
``TData`` and the forecasting API (e.g. ``src/TData.jl:46``,
``src/forecasting.jl:29``).  The port needs a single
numeric time axis for the GP kernels, so every user-facing entry point funnels its
dates through :func:`dates_to_float`, which maps any reasonable date-like input
(numpy ``datetime64``, pandas timestamps, ``datetime.date``/``datetime.datetime``,
or plain numbers) to float64 *days since the Unix epoch*.  Plain numbers pass
through unchanged, so purely numeric time axes are first-class too.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

__all__ = ["dates_to_float", "as_date_array"]

_EPOCH = _dt.date(1970, 1, 1)


def as_date_array(ds) -> np.ndarray:
    """Collect any iterable of date-likes into a 1-D numpy array (kept as given).

    The returned array preserves the caller's element type (object array for
    ``datetime.date`` entries, ``datetime64`` for numpy/pandas input, float for
    numeric input) so containers can round-trip the user's dates unchanged.
    """
    if isinstance(ds, np.ndarray) and ds.ndim == 1:
        return ds
    # pandas Series / DatetimeIndex expose .to_numpy()
    to_numpy = getattr(ds, "to_numpy", None)
    if to_numpy is not None:
        arr = to_numpy()
        if isinstance(arr, np.ndarray) and arr.ndim == 1:
            return arr
    seq = list(ds)
    if seq and isinstance(seq[0], (_dt.date, _dt.datetime)):
        # keep python date objects intact (object dtype)
        out = np.empty(len(seq), dtype=object)
        out[:] = seq
        return out
    return np.asarray(seq)


def dates_to_float(ds) -> np.ndarray:
    """Convert a 1-D date-like sequence to float64 days since 1970-01-01.

    Numeric input is passed through as float64.  Raises ``TypeError`` for
    unsupported element types.
    """
    arr = as_date_array(ds)
    if arr.dtype.kind in "Mm":  # datetime64 / timedelta64
        # Normalize to nanoseconds then to days (float) for sub-day resolution.
        ns = arr.astype("datetime64[ns]").astype(np.int64)
        return ns / (24.0 * 3600.0 * 1e9)
    if arr.dtype.kind in "fiu":
        return arr.astype(np.float64)
    if arr.dtype == object:
        out = np.empty(arr.shape[0], dtype=np.float64)
        for i, v in enumerate(arr):
            if isinstance(v, _dt.datetime):
                out[i] = v.timestamp() / (24.0 * 3600.0)
            elif isinstance(v, _dt.date):
                out[i] = (v - _EPOCH).days
            elif isinstance(v, (int, float, np.integer, np.floating)):
                out[i] = float(v)
            else:
                # last resort: numpy datetime64 scalar or similar
                try:
                    ns = np.datetime64(v, "ns").astype(np.int64)
                    out[i] = ns / (24.0 * 3600.0 * 1e9)
                except Exception as exc:  # pragma: no cover
                    raise TypeError(f"Unsupported date element: {v!r}") from exc
        return out
    raise TypeError(f"Unsupported date array dtype: {arr.dtype}")
