"""Operation and byte counts of the fit's LML programs, and MFU on an H100.

Port of the JAX package's ``utils/flops.py``.  ``fit_cost_analysis`` keeps
its composition of calls per capacity segment (``fit_call_counts``); the
cost of one batched LML call is an analytic count of the algorithm the
port runs (``_lml_program_costs``), since there is no XLA to ask:

* the covariance walk over the lower triangle, n (n + 1) / 2 elements a
  particle, at the per-node-type operation counts of ``FWD_OPS`` and
  ``BWD_OPS`` (counted from the node bodies of ``csrc/heapwalk.cuh``; an
  exp, log, sinpi or division is one operation, an FMA two) for the live
  slots of the trees;
* n^3 / 3 for the Cholesky factorisation, n^3 / 3 for the triangular
  inverse and n^3 / 3 for A^-1 = X^T X, where the core forms them (K1's
  backward; the composed core's forward above capacity 512);
* the bytes of the call's operands read once and its results written once.

XLA's count differs in three ways: it counts the program as compiled, so
its interpreter evaluates every node type at every slot and selects
(masked lanes count), it counts the full n x n plane, and it counts a
transcendental as one FLOP as here.  So this count is lower, and it moves
with the trees a fit holds; ``types`` stands for them (a fixed sample of
the config's prior by default).

The peaks are the NVIDIA H100 SXM data sheet's (dense, 700 W): FP32
outside the tensor cores (the covariance walks), FP64 on the tensor cores
(the Cholesky engine of K1, K2 and K3, ``csrc/chol_blocked.cuh``) and HBM
bandwidth.  ``chip_smoke.py`` takes its kernel bounds from here.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "PEAK_FP32", "PEAK_FP64_TENSOR", "PEAK_BYTES", "FWD_OPS", "BWD_OPS",
    "ELEM_OPS", "kernel_costs", "bound_ms", "fit_call_counts",
    "fit_cost_analysis", "mfu",
]

PEAK_FP32 = 67e12
PEAK_FP64_TENSOR = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations per element and heap node, by node type code: the
# forward walk, then the backward sweep's own work; plus the per-element
# distance terms.
FWD_OPS = np.array([0, 0, 4, 4, 6, 7, 1, 1, 19])
BWD_OPS = np.array([0, 2, 8, 5, 15, 17, 0, 2, 35])
ELEM_OPS = 5

# the composed core's capacities (ops/lml.py): above the fused kernels' 512
_FUSED_MAX_N = 512
_PRIOR_SAMPLE = 256


def kernel_costs(types, n, m=None, sym=True):
    """{kernel: (bytes, operations)} of each kernel's call at the P trees
    ``types`` (P, N) and capacity n (K7F/K7B: n x m points shared by the
    particles; ``sym``: K(x, x)): bytes of its inputs read once and outputs
    written once, against the operations these trees need (K4/K5 and a
    symmetric K7F/K7B: lower-triangle elements; a general K7F/K7B: all
    n m elements; Cholesky and triangular inverse n^3 / 3 each).  A
    symmetric or triangular input (K3/K6a's SPD matrix, K6b's factor) is
    read as its lower triangle only; a dense (n, n) output is written in
    full."""
    t = np.asarray(types)
    P, N = t.shape
    m = n if m is None else m
    sym = sym and m == n
    E = n * (n + 1) / 2
    pairs = E if sym else n * m
    pts = 4 * (n if sym else n + m)
    fwd = float((ELEM_OPS + FWD_OPS[t].sum(1)).sum())   # over particles
    bwd = float(BWD_OPS[t].sum())
    heap = 4 * (P * N + 3 * P * N)
    chol = P * (n ** 3 / 3 + 2 * n * n)
    tri = 4 * P * n * (n + 1) / 2 + 4 * P * n * n   # lower in, dense out
    return {
        "K1": (heap + 4 * 4 * P * n + 4 * (P + 3 * P * N + 2 * P * n),
               E * (2 * fwd + bwd + 6 * P) + chol + P * 2 * n ** 3 / 3),
        "K2": (heap + 4 * 4 * P * n + 4 * P, E * (fwd + 3 * P) + chol),
        "K3": (tri, P * 2 * n ** 3 / 3),
        "K4": (heap + 4 * P * n + 4 * P * n * n, E * fwd),
        "K5": (heap + 4 * P * n + 4 * P * n * n + 12 * P * N,
               E * (fwd + bwd + P)),
        "K6a": (tri + 8 * P * n, chol),
        "K6b": (tri, P * n ** 3 / 3),
        "K7F": (heap + pts + 4 * P * n * m, pairs * fwd),
        "K7B": (heap + pts + 4 * P * n * m + 12 * P * N,
                pairs * (fwd + bwd + P)),
    }


def bound_ms(nbytes, ops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the H100's memory rate and the operations over its FP32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _prior_types(config):
    """A fixed sample of ``config``'s prior trees (P, N)."""
    from ..models.structures import sample_particle

    rng = np.random.default_rng(0)
    return np.stack([sample_particle(rng, config)[0]
                     for _ in range(_PRIOR_SAMPLE)])


def _lml_program_costs(P, cap, config, types=None):
    """(fwd_ops, grad_ops, fwd_bytes, grad_bytes) of one batched masked LML
    evaluation (value) and one gradient (value and gradient) at P particles
    and capacity ``cap``, for the trees ``types`` (any number of rows,
    scaled to P; None: a fixed sample of ``config``'s prior).

    Up to capacity 512 a value is K2's work and a gradient K1's; above it
    the composed core: K4, the masked A, Cholesky, triangular inverse and
    X^T X, alpha = A^-1 ym, and for the gradient dA, its mask product and
    K5.  The bytes are the call's operands and results, the same for both
    cores."""
    t = _prior_types(config) if types is None else np.asarray(types)
    scale = P / t.shape[0]
    n = int(cap)
    c = kernel_costs(t, n)
    fwd_bytes, grad_bytes = c["K2"][0], c["K1"][0]
    if n <= _FUSED_MAX_N:
        fwd, grad = c["K2"][1], c["K1"][1]
    else:
        Pt = t.shape[0]
        fwd = (c["K4"][1] + c["K3"][1] + Pt * n ** 3 / 3
               + 4 * Pt * n * n)
        grad = fwd + c["K5"][1] + 4 * Pt * n * n
    return (fwd * scale, grad * scale, fwd_bytes * scale,
            grad_bytes * scale)


def fit_call_counts(*, schedule, cap_full, n_mcmc, n_hmc, n_leapfrog):
    """[(capacity, value calls, gradient calls), ...] of the fit, by
    capacity segment: per schedule step with HMC, 1 reweight value and 1
    gradient seeding the sweep, then per structure move 1 proposal and
    n_hmc x n_leapfrog gradients (the device-proposal engine carries the
    potential and its gradient across moves and trajectories); without
    HMC, 1 reweight and n_mcmc proposal values per step."""
    from ..inference.smc import schedule_segments

    out = []
    for cap_seg, steps in schedule_segments(schedule, cap_full):
        n_steps = len(steps)
        if n_hmc > 0:
            fwd_calls = n_steps
            grad_calls = n_steps * (1 + n_mcmc * (1 + n_hmc * n_leapfrog))
        else:
            fwd_calls = n_steps * (1 + n_mcmc)
            grad_calls = 0
        out.append((cap_seg, fwd_calls, grad_calls))
    return out


def fit_cost_analysis(*, P, config, schedule, cap_full, n_mcmc, n_hmc,
                      n_leapfrog, types=None):
    """Total (operations, bytes) of the capacity-bucketed fit: each
    segment's call counts (``fit_call_counts``) times the cost of one call
    at its capacity (``_lml_program_costs``).  ``types``: trees whose walks
    stand for every call's (None: a sample of ``config``'s prior)."""
    total_ops, total_bytes = 0.0, 0.0
    for cap_seg, fwd_calls, grad_calls in fit_call_counts(
            schedule=schedule, cap_full=cap_full, n_mcmc=n_mcmc,
            n_hmc=n_hmc, n_leapfrog=n_leapfrog):
        f_fwd, f_grad, b_fwd, b_grad = _lml_program_costs(
            P, cap_seg, config, types)
        total_ops += fwd_calls * f_fwd + grad_calls * f_grad
        total_bytes += fwd_calls * b_fwd + grad_calls * b_grad
    return total_ops, total_bytes


def mfu(flops: float, seconds: float) -> dict:
    """Achieved rate of a measured run and its share of each H100 peak."""
    achieved = flops / max(seconds, 1e-12)
    return {
        "fit_tflops": round(flops / 1e12, 3),
        "achieved_tflops_per_s": round(achieved / 1e12, 3),
        "mfu_vs_h100_fp32_peak": round(achieved / PEAK_FP32, 5),
        "mfu_vs_h100_fp64_tensor_peak": round(achieved / PEAK_FP64_TENSOR,
                                              5),
    }
