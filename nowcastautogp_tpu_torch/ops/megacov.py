"""Batched covariance K(x_p, x_p) of P heap trees: CUDA kernels K4/K5.

* ``megacov_fwd(types, params, x)`` -> K (P, n, n): K4 on a CUDA tensor,
  the torch interpreter (``eval_cov_batch``) on a CPU tensor;
* ``megacov_bwd(types, params, x, dK)`` -> dparams (P, N, 3), the VJP: K5
  on a CUDA tensor; on a CPU tensor the same fold of the cotangent
  (``tril(dK + dK^T, -1) + diag(dK)``) followed by the interpreter's VJP
  over the lower triangle, so the CPU tests check the fold;
* ``CovFn`` joins them as an autograd function and ``cov_batched`` is its
  entry (heap padding, dtypes), the counterpart of the JAX package's
  ``ops/pallas_megacov.py::cov_batched_fused``.

On a CUDA tensor the wrappers launch their kernel or raise: a shape
outside the envelope (N in {7, 15, 31, 63}, 8 <= n <= 4096, n % 8 == 0)
or a failed launch is an error, never a fallback.  Each wrapper call is one
C call and one count, though it runs a launch per heap class.  The kernels
replace ``pallas_megacov.py::_cov_fwd_kernel`` (K4) and
``::_cov_bwd_kernel`` (K5); they are the symmetric path of K7F/K7B's tile
code (``csrc/covtile.cuh``, which says what bounds them; ``csrc/megacov.cu``
its plan for K4/K5), so K4 gives K7F's bits.
"""

from __future__ import annotations

import torch

from .cudalib import LaunchCounter, library, raise_on
from .kernels import eval_cov_batch
from .megalml import _HEAP_SIZES, _pad_heap

__all__ = [
    "megacov_fwd", "megacov_bwd", "megacov_fwd_plain", "megacov_bwd_plain",
    "megacov_supported", "fold_cotangent", "CovFn", "cov_batched",
    "K4_LAUNCHES", "K5_LAUNCHES", "reset_launch_counts", "MAX_MEGA_N",
]

# Launches of K4 and K5, counted where each wrapper launches its kernel;
# read as K4_LAUNCHES and K5_LAUNCHES.
_LAUNCHES = LaunchCounter("K4_LAUNCHES", "K5_LAUNCHES")

# The kernels' largest n.  The JAX package's kernel ends at 2048 and its
# interpreter runs beyond; the port's kernels run the same tiles up to here.
MAX_MEGA_N = 4096


def reset_launch_counts() -> None:
    """Set both launch counters to zero."""
    _LAUNCHES.reset()


def megacov_supported(n_nodes: int, n: int) -> bool:
    """The kernels' envelope: heaps of at most 63 slots, 8 <= n <= 4096,
    n a multiple of 8 (the JAX package's ``megacov_supported`` up to its
    2048)."""
    return n_nodes <= _HEAP_SIZES[-1] and 8 <= n <= MAX_MEGA_N and n % 8 == 0


def fold_cotangent(dK):
    """``tril(dK + dK^T, -1) + diag(dK)``: the cotangent on the lower
    triangle that gives the same VJP, because dK_ij/dp = dK_ji/dp."""
    low = torch.tril(dK + dK.transpose(-1, -2), diagonal=-1)
    return low + torch.diag_embed(torch.diagonal(dK, dim1=-2, dim2=-1))


def megacov_fwd_plain(types, params, x):
    """Plain version of K4: the torch interpreter."""
    return eval_cov_batch(types, params, x, x)


def megacov_bwd_plain(types, params, x, dK):
    """Plain version of K5: fold, then the interpreter's VJP."""
    with torch.enable_grad():
        p = params.detach().requires_grad_(True)
        K = eval_cov_batch(types, p, x, x)
        (g,) = torch.autograd.grad((K * fold_cotangent(dK)).sum(), p)
    return g


def _check(types, params, x, dK=None):
    """Validate the kernels' operands; returns (P, N, n)."""
    P, N = types.shape
    n = x.shape[-1]
    expect = {"types": (types, torch.int32, (P, N)),
              "params": (params, torch.float32, (P, N, 3)),
              "x": (x, torch.float32, (P, n))}
    if dK is not None:
        expect["dK"] = (dK, torch.float32, (P, n, n))
    for name, (t, dtype, shape) in expect.items():
        if t.device != types.device:
            raise ValueError(f"{name} is on {t.device}, types on {types.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N not in _HEAP_SIZES or not megacov_supported(N, n):
        raise NotImplementedError(
            f"heap size {N} x n={n} is outside the covariance kernels' "
            f"envelope (N in {_HEAP_SIZES}, 8 <= n <= {MAX_MEGA_N}, "
            "n % 8 == 0)")
    return P, N, n


def _device(types):
    dev = types.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no covariance kernel for device {types.device}")
    return dev


def megacov_fwd(types, params, x):
    """K4: K(x_p, x_p) -> (P, n, n)."""
    if _device(types) == "cpu":
        return megacov_fwd_plain(types, params, x)
    P, N, n = _check(types, params, x)
    K = torch.empty((P, n, n), dtype=torch.float32, device=types.device)
    rc = library().megacov_fwd(
        N, P, n, types.data_ptr(), params.data_ptr(), x.data_ptr(),
        K.data_ptr(), torch.cuda.current_stream(types.device).cuda_stream)
    raise_on(rc, "K4 megacov_fwd")
    _LAUNCHES.bump("K4_LAUNCHES")
    return K


def megacov_bwd(types, params, x, dK):
    """K5: cotangent dK (P, n, n) -> dparams (P, N, 3)."""
    if _device(types) == "cpu":
        return megacov_bwd_plain(types, params, x, dK)
    P, N, n = _check(types, params, x, dK)
    lib = library()
    dev = types.device
    dparams = torch.empty((P, N, 3), dtype=torch.float32, device=dev)
    partial = torch.empty((P, lib.megacov_tiles(n), 3 * N),
                          dtype=torch.float32, device=dev)
    rc = lib.megacov_bwd(
        N, P, n, types.data_ptr(), params.data_ptr(), x.data_ptr(),
        dK.data_ptr(), dparams.data_ptr(), partial.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(rc, "K5 megacov_bwd")
    _LAUNCHES.bump("K5_LAUNCHES")
    return dparams


class CovFn(torch.autograd.Function):
    """K4 forward, K5 backward; gradients flow to ``params`` only (``types``
    and ``x`` are data).  Operands arrive padded and contiguous."""

    @staticmethod
    def forward(ctx, types, params, x):
        ctx.save_for_backward(types, params, x)
        return megacov_fwd(types, params, x)

    @staticmethod
    def backward(ctx, dK):
        types, params, x = ctx.saved_tensors
        return None, megacov_bwd(types, params, x, dK.contiguous()), None


def cov_batched(types, params, x):
    """Differentiable K(x_p, x_p) of P trees -> (P, n, n).

    types (P, N) heap encoding, params (P, N, 3), x (P, n) or a shared (n,).
    """
    P = types.shape[0]
    tk, pk = _pad_heap(types.to(torch.int32).contiguous(), params.contiguous())
    return CovFn.apply(tk, pk, x.expand(P, x.shape[-1]).contiguous())


def __getattr__(name):
    if name in _LAUNCHES:
        return _LAUNCHES[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
