"""Elementwise application helper for user-supplied transformations.

The reference broadcasts transformation closures elementwise
(``inv_transformation.(matrix)``, ``src/forecasting.jl:50``).
Our transforms are numpy-vectorized, but users may pass scalar-only callables
(e.g. ``math.log``); this helper applies vectorized when possible and falls
back to per-element application for any array rank.
"""

from __future__ import annotations

import numpy as np

__all__ = ["apply_elementwise"]


def apply_elementwise(fn, values: np.ndarray) -> np.ndarray:
    values = np.asarray(values)
    try:
        out = np.asarray(fn(values))
        if out.shape != values.shape:
            raise ValueError("non-elementwise transformation result")
        return out
    except Exception:
        flat = np.asarray([fn(v) for v in values.ravel().tolist()])
        return flat.reshape(values.shape)
