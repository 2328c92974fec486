"""Data transformations to/from the unconstrained GP modeling scale.

Port of the JAX package's re-design of the reference's transformation factory
(``src/transformations.jl``).  All transforms here are
host-side numpy (they run once per series at setup and once per forecast
matrix on the way out — never inside the device hot loop), vectorized so they
apply elementwise to scalars, vectors, or full ``(n_dates, n_draws)`` forecast
matrices.

Behavioral contract reproduced from the reference:

* ``"percentage"``: scaled logit, ``y -> logit((y+offset)/100)`` /
  ``y -> max(logistic(y)*100 - offset, 0)`` (``src/transformations.jl:143-147``).
* ``"positive"``: log with offset, ``y -> log(y+offset)`` /
  ``y -> max(exp(y)-offset, 0)`` (``src/transformations.jl:148-150``).
* ``"boxcox"``: MLE-fitted λ with a degenerate-λ fallback to ``"positive"``
  when the transformed spread collapses relative to a plain log
  (issue #51 semantics, ``src/transformations.jl:151-170``), and an inverse
  with edge-case clamping (``src/transformations.jl:6-44``).
* Offset rule: half the minimum *positive* value when any value is zero, else
  zero; asserts non-empty, all values >= 0 (``src/transformations.jl:51-61``).
* Unknown names raise ``AssertionError`` (``src/transformations.jl:172``).
"""

from __future__ import annotations

import logging
import warnings

import numpy as np

__all__ = ["get_transformations", "boxcox_mle_lambda"]

logger = logging.getLogger("nowcastautogp_tpu_torch")


def _get_offset(values: np.ndarray) -> float:
    """Offset = half the minimum positive value if any value is 0, else 0.

    Mirrors ``_get_offset`` (``src/transformations.jl:51-61``), including the
    assertions on non-emptiness and non-negativity.
    """
    values = np.asarray(values)
    assert values.size > 0, "Values array must not be empty"
    assert np.all(values >= 0), (
        "All values must be non-negative for the selected transformations"
    )
    vmin = values.min()
    if vmin == 0:
        positives = values[values > 0]
        # all-zero input: no positive value to halve; use 0.5 as a benign offset
        return float(positives.min() / 2) if positives.size else 0.5
    return 0.0


def _maybe_scalar(out: np.ndarray, scalar_in: bool):
    return float(out) if scalar_in and np.ndim(out) == 0 else out


def _logit(p):
    return np.log(p) - np.log1p(-p)


def _logistic(x):
    # numerically stable elementwise sigmoid
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _boxcox_forward(x: np.ndarray, lam: float) -> np.ndarray:
    """Plain (unnormalized) Box-Cox: ``(x^λ - 1)/λ``, ``log(x)`` at λ=0.

    Computed in log space (``expm1(λ·log x)/λ``) so extreme λ (the degenerate
    cases the reference's issue-#51 guard exists for) do not overflow.
    """
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if lam == 0.0:
            return np.log(x)
        return np.expm1(lam * np.log(x)) / lam


def boxcox_mle_lambda(x: np.ndarray) -> float:
    """Profile-likelihood MLE of the Box-Cox λ for positive data.

    Maximizes ``LL(λ) = -(n/2)·log(var(z_λ)) + (λ-1)·Σ log x`` over λ via a
    coarse grid followed by golden-section refinement.  Fills the role of
    ``BoxCox.fit`` in the reference (``src/transformations.jl:154``); like the
    reference's dependency the search is unbounded enough that near-constant
    data can return a pathological λ — which the degeneracy fallback in
    :func:`get_transformations` then catches.
    """
    x = np.asarray(x, dtype=np.float64)
    logx = np.log(x)
    sum_logx = logx.sum()
    n = x.size

    def negll(lam: float) -> float:
        z = _boxcox_forward(x, lam)
        if not np.all(np.isfinite(z)):
            return np.inf
        with np.errstate(over="ignore"):
            var = z.var()
        if var <= 0 or not np.isfinite(var):
            return np.inf
        return 0.5 * n * np.log(var) - (lam - 1.0) * sum_logx

    # Coarse grid wide enough to reach pathological λ on near-constant data.
    grid = np.concatenate(
        [np.linspace(-300.0, -5.0, 60), np.linspace(-5.0, 5.0, 201), np.linspace(5.0, 300.0, 60)]
    )
    vals = np.array([negll(l) for l in grid])
    if not np.any(np.isfinite(vals)):
        return 1.0
    i = int(np.nanargmin(np.where(np.isfinite(vals), vals, np.inf)))
    lo = grid[max(i - 1, 0)]
    hi = grid[min(i + 1, grid.size - 1)]
    # Golden-section refinement on [lo, hi].
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = float(lo), float(hi)
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = negll(c), negll(d)
    for _ in range(80):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = negll(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = negll(d)
        if abs(b - a) < 1e-10:
            break
    return float((a + b) / 2)


def _inv_boxcox(lam: float, offset: float, max_value: float):
    """Inverse Box-Cox closure with the reference's edge-case handling.

    Mirrors ``_inv_boxcox`` (``src/transformations.jl:6-44``): λ>0 clamps
    ``λy+1`` to ≥1e-10; λ<0 maps ``λy+1 ≤ 0`` to zero (probability mass at
    zero) and clamps blow-ups to ``1000·max_value``; λ≈0 uses ``exp``; the
    result is always clamped to ≥ 0 and finite.
    """

    def inverse(y):
        scalar_in = np.ndim(y) == 0
        y = np.asarray(y, dtype=np.float64)
        lyp1 = lam * y + 1.0
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            if lam > 0:
                safe = np.maximum(lyp1, 1e-10)
                result = np.exp(np.log(safe) / lam) - offset
            elif lam < 0:
                # normal branch: lyp1 sufficiently positive
                safe = np.where(lyp1 > 1e-10, lyp1, 1.0)
                normal = np.exp(np.log(safe) / lam) - offset
                # tiny-positive branch: clamp the blow-up to 1000x max observed
                tiny = np.where(lyp1 > 0, lyp1, 1.0)
                max_reasonable = 1000.0 * max_value
                clamped = np.minimum(np.exp(np.log(tiny) / lam), max_reasonable) - offset
                result = np.where(
                    lyp1 > 1e-10,
                    normal,
                    np.where(lyp1 <= 0, 0.0, clamped),
                )
            else:
                result = np.exp(y) - offset
        result = np.maximum(result, 0.0)
        result = np.where(np.isfinite(result), result, 0.0)
        return _maybe_scalar(result, scalar_in)

    return inverse


def get_transformations(transform_name: str, values):
    """Return ``(forward, inverse)`` transformation closures for a series.

    Port of ``get_transformations``
    (``src/transformations.jl:139-174``).  ``transform_name``
    must be one of ``"percentage"``, ``"positive"``, ``"boxcox"``; anything
    else raises ``AssertionError`` (reference ``:172``).
    """
    values = np.asarray(list(values) if not isinstance(values, np.ndarray) else values)
    offset = _get_offset(values)

    if transform_name == "percentage":
        logger.info("Using percentage transformation")

        def forward(y):
            scalar_in = np.ndim(y) == 0
            out = _logit((np.asarray(y, dtype=np.float64) + offset) / 100.0)
            return _maybe_scalar(out, scalar_in)

        def inverse(y):
            scalar_in = np.ndim(y) == 0
            out = np.maximum(_logistic(y) * 100.0 - offset, 0.0)
            return _maybe_scalar(out, scalar_in)

        return forward, inverse

    if transform_name == "positive":
        logger.info("Using positive transformation with offset = %s", offset)

        def forward(y):
            scalar_in = np.ndim(y) == 0
            out = np.log(np.asarray(y, dtype=np.float64) + offset)
            return _maybe_scalar(out, scalar_in)

        def inverse(y):
            scalar_in = np.ndim(y) == 0
            with np.errstate(over="ignore"):
                out = np.maximum(np.exp(np.asarray(y, dtype=np.float64)) - offset, 0.0)
            return _maybe_scalar(out, scalar_in)

        return forward, inverse

    if transform_name == "boxcox":
        max_values = float(values.max())
        shifted = values.astype(np.float64) + offset
        lam = boxcox_mle_lambda(shifted)
        transformed = _boxcox_forward(shifted, lam)
        bc_range = float(transformed.max() - transformed.min()) if np.all(
            np.isfinite(transformed)
        ) else np.nan
        log_shifted = np.log(shifted)
        log_range = float(log_shifted.max() - log_shifted.min())
        # Degeneracy guard (issue #51): near-constant data can yield a
        # pathological λ that collapses the transform; fall back to log.
        if not np.all(np.isfinite(transformed)) or not np.isfinite(bc_range) or (
            bc_range <= 1e-2 * log_range
        ):
            warnings.warn(
                f"Box-Cox transformation degenerate (lambda = {lam}, transformed "
                f"range = {bc_range}); falling back to log transformation (issue #51).",
                stacklevel=2,
            )
            return get_transformations("positive", values)
        logger.info(
            "Using Box-Cox transformation with lambda = %s and offset = %s", lam, offset
        )

        def forward(y):
            scalar_in = np.ndim(y) == 0
            out = _boxcox_forward(np.asarray(y, dtype=np.float64) + offset, lam)
            return _maybe_scalar(out, scalar_in)

        return forward, _inv_boxcox(lam, offset, max_values)

    raise AssertionError(f"Unknown transform_name: {transform_name}")
