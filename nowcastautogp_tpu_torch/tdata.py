"""Typed container for transformed time-series data.

Port of the JAX package's re-design of the reference's ``TData`` struct
(``src/TData.jl:46-74``): an immutable record carrying the date
axis, the transformed target values ``y`` (what the GP models), and the original
``values`` (for reporting / inverse checks).  Construction applies the
transformation elementwise, promotes the numeric dtype of ``y``/``values`` to a
common type, and asserts equal lengths — matching the reference's validation
semantics (``AssertionError`` on mismatched lengths, ``src/TData.jl:52``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .utils.apply import apply_elementwise as _apply_elementwise
from .utils.dates import as_date_array

__all__ = ["TData", "create_transformed_data"]


@dataclasses.dataclass(frozen=True)
class TData:
    """Container of dates ``ds``, transformed values ``y``, original ``values``.

    Mirrors ``TData{D, F}`` of the reference (``src/TData.jl:46``). Instances are
    immutable; ``y`` and ``values`` share a promoted floating dtype.
    """

    ds: np.ndarray
    y: np.ndarray
    values: np.ndarray

    def __init__(self, ds, values, *, transformation):
        ds_arr = as_date_array(ds)
        vals = np.asarray(list(values) if not isinstance(values, np.ndarray) else values)
        assert len(ds_arr) == len(vals), (
            "length of `ds` should match length of `values`"
        )
        y = _apply_elementwise(transformation, vals)
        # Promote to a common numeric type (reference: promote_type, src/TData.jl:58)
        common = np.result_type(y.dtype, vals.dtype)
        object.__setattr__(self, "ds", ds_arr)
        object.__setattr__(self, "y", y.astype(common))
        object.__setattr__(self, "values", vals.astype(common))

    def __len__(self) -> int:
        return len(self.ds)

    def __eq__(self, other) -> bool:  # structural equality for tests
        if not isinstance(other, TData):
            return NotImplemented
        return (
            len(self.ds) == len(other.ds)
            and bool(np.all(self.ds == other.ds))
            and np.array_equal(self.y, other.y)
            and np.array_equal(self.values, other.values)
        )


def create_transformed_data(ds, values, *, transformation=lambda y: y) -> TData:
    """Convenience constructor from any iterables (reference ``src/TData.jl:72-74``)."""
    return TData(list(ds), list(values), transformation=transformation)
