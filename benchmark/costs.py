"""The work count behind ``lml_roofline.*`` and ``mfu.*``.

A frozen copy of the program's analytic LML arithmetic with two changes,
so that the count reads the same work whatever implements it:

* one formula at every capacity.  A value is the lower-triangle forward
  walk of the trees, a Cholesky (n^3 / 3) and its solves; a gradient adds
  the backward walk and A^-1 (2 n^3 / 3).  Bytes are the call's operands
  read once and its results written once;
* call counts from the algorithm: per SMC step one reweight value; per
  structure move one proposal value and 1 + n_hmc x n_leapfrog gradients
  (the move's HMC starts with one evaluation, then one a leapfrog); a
  nowcast refresh two reweight values (old and new data) and
  1 + n_hmc x n_leapfrog gradients over its S x P rows.

The count reads only the algorithm's parameters, the cell's sizes and
the fitted trees (``node_types``); the final trees stand for every call
of the fit, so the early, shallower steps are over-counted.  Peaks: the
NVIDIA H100 SXM data sheet (dense, 700 W): 67 TFLOP/s for float32
outside the tensor cores and for float64 on them, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import numpy as np

from .reference import data

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# float32 operations per element and heap node, by node type code (0-8):
# the forward walk, then the backward sweep's own work; plus the
# per-element distance terms.
FWD_OPS = np.array([0, 0, 4, 4, 6, 7, 1, 1, 19])
BWD_OPS = np.array([0, 2, 8, 5, 15, 17, 0, 2, 35])
ELEM_OPS = 5


def call_cost(types, n: int, grad: bool):
    """(bytes, operations) of one batched LML call over the trees
    ``types`` (P, N) at capacity n: a value, or a value and gradient."""
    t = np.asarray(types)
    P, N = t.shape
    E = n * (n + 1) / 2
    fwd = float((ELEM_OPS + FWD_OPS[t].sum(1)).sum())
    heap = 4 * (P * N + 3 * P * N)
    chol = P * (n ** 3 / 3 + 2 * n * n)
    if grad:
        bwd = float(BWD_OPS[t].sum())
        return (heap + 4 * 4 * P * n + 4 * (P + 3 * P * N + 2 * P * n),
                E * (2 * fwd + bwd + 6 * P) + chol + P * 2 * n ** 3 / 3)
    return heap + 4 * 4 * P * n + 4 * P, E * (fwd + 3 * P) + chol


def least_s(nbytes: float, ops: float) -> float:
    """The least time of a call: bytes at the HBM rate or operations at
    the peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS)


def fit_calls(n_train, proportion, n_mcmc, n_hmc, n_leapfrog):
    """[(capacity, value calls, gradient calls), ...] of a fit by
    capacity segment of its schedule."""
    out = []
    for cap, steps in data.schedule_segments(
            data.linear_schedule(n_train, proportion),
            data.capacity(n_train)):
        k = len(steps)
        out.append((cap, k * (1 + n_mcmc),
                     k * n_mcmc * (1 + n_hmc * n_leapfrog)))
    return out


def refresh_calls(n_new, n_hmc, n_leapfrog, cap_base):
    """[(capacity, value calls, gradient calls)] of one nowcast refresh
    request on rows conditioned on ``n_new`` points, whose base buffer
    has capacity ``cap_base``."""
    cap = max(cap_base, data.capacity(n_new))
    return [(cap, 2, 1 + n_hmc * n_leapfrog)]


def work(types, calls) -> dict:
    """Operations, bytes and least seconds of ``calls`` over the trees
    ``types`` (rows, N)."""
    ops = nbytes = least = 0.0
    for cap, n_val, n_grad in calls:
        for count, grad in ((n_val, False), (n_grad, True)):
            if count:
                b, o = call_cost(types, cap, grad)
                ops += count * o
                nbytes += count * b
                least += count * least_s(b, o)
    return {"ops": ops, "bytes": nbytes, "least_s": least}
