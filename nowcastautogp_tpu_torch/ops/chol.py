"""Blocked Cholesky solve and triangular inverse: CUDA kernels K6a/K6b.

The LML core of the "pallas" LML backend (``ops/lml.py``), the counterpart
of the JAX package's ``ops/pallas_chol.py``:

* ``chol_solve_batched(K, ym)`` -> (L, alpha) with L L^T = K and
  K alpha = ym: K6a on a CUDA tensor, ``cholesky_nan`` and
  ``torch.cholesky_solve`` on a CPU tensor;
* ``tri_inverse(L)`` -> X = L^-1: K6b on a CUDA tensor, a triangular solve
  against I on a CPU tensor; ``chol_inverse_batched(L)`` -> K^-1 = X^T X,
  the product left to ``torch.matmul`` as the JAX package leaves it to XLA;
* ``lml_core(K, ym)`` -> -0.5 (ym^T K^-1 ym + logdet K) per particle, an
  autograd function whose forward runs K6a and saves (L, alpha), and whose
  backward is the analytic dK = g/2 (alpha alpha^T - K^-1), dym = -g alpha
  with K^-1 from K6b: no autograd through the factorisation.

K carries the masked-identity contract of ``ops/lml.py``.  The envelope is
32 <= n <= 2048 with n a multiple of 32, checked on both devices; n off the
32 grid is a ``ValueError``, as in the JAX package.  A particle that is not
SPD is NaN in its own lane only, and the caller's guard rejects it.  On a
CUDA tensor the wrappers launch their kernel or raise.  The kernels replace
``pallas_chol.py::_chol_solve_kernel`` (K6a) and ``::_tri_inverse_kernel``
(K6b); ``csrc/chol.cu`` says what bounds them and how.
"""

from __future__ import annotations

import torch

from .cudalib import LaunchCounter, library, raise_on
from .megalml import cholesky_nan

__all__ = [
    "chol_solve_batched", "chol_solve_plain", "tri_inverse",
    "tri_inverse_plain", "chol_inverse_batched", "lml_core", "CholCoreFn",
    "K6A_LAUNCHES", "K6B_LAUNCHES", "reset_launch_counts",
]

# Launches of K6a and K6b, counted where each wrapper launches its kernel;
# read as K6A_LAUNCHES and K6B_LAUNCHES.
_LAUNCHES = LaunchCounter("K6A_LAUNCHES", "K6B_LAUNCHES")

_B = 32
_MAX_N = 2048


def reset_launch_counts() -> None:
    """Set both launch counters to zero."""
    _LAUNCHES.reset()


def chol_solve_plain(K, ym):
    """Plain version of K6a: ``cholesky_nan`` and ``cholesky_solve``."""
    L = cholesky_nan(K)
    return L, torch.cholesky_solve(ym[..., None], L)[..., 0]


def tri_inverse_plain(L):
    """Plain version of K6b: a triangular solve against I."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _check(M, which, vec=None):
    """Validate a (P, n, n) operand (and a (P, n) one); returns (P, n, dev)."""
    P, n = M.shape[0], M.shape[-1]
    if n % _B != 0:
        raise ValueError(
            f"{which}: the blocked Cholesky needs n to be a multiple of {_B} "
            f"(got n={n}); pad the capacity")
    if not _B <= n <= _MAX_N:
        raise NotImplementedError(
            f"{which}: n={n} is outside the kernels' envelope ({_B} <= n <= "
            f"{_MAX_N})")
    dev = M.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no {which} kernel for device {M.device}")
    if dev == "cuda":
        expect = [(M, (P, n, n))] + ([(vec, (P, n))] if vec is not None else [])
        for t, shape in expect:
            if t.device != M.device:
                raise ValueError(f"{which}: operands on {t.device} and {M.device}")
            if t.dtype != torch.float32 or tuple(t.shape) != shape:
                raise ValueError(f"{which}: expected float32 {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{which}: operands must be contiguous")
    return P, n, dev


def chol_solve_batched(K, ym):
    """K6a: (L (P, n, n) lower, alpha (P, n)) with L L^T = K, K alpha = ym."""
    P, n, dev = _check(K, "K6a chol_solve", ym)
    if dev == "cpu":
        return chol_solve_plain(K, ym)
    L = torch.empty_like(K)
    alpha = torch.empty_like(ym)
    dws = torch.empty((P, n, _B), dtype=torch.float32, device=K.device)
    rc = library().chol_solve(
        P, n, K.data_ptr(), ym.data_ptr(), L.data_ptr(), alpha.data_ptr(),
        dws.data_ptr(), torch.cuda.current_stream(K.device).cuda_stream)
    raise_on(rc, "K6a chol_solve")
    _LAUNCHES.bump("K6A_LAUNCHES")
    return L, alpha


def tri_inverse(L):
    """K6b: X = L^-1 (P, n, n) lower from a lower Cholesky factor L."""
    P, n, dev = _check(L, "K6b tri_inverse")
    if dev == "cpu":
        return tri_inverse_plain(L)
    X = torch.empty_like(L)
    dws = torch.empty((P, n, _B), dtype=torch.float32, device=L.device)
    rc = library().chol_tri_inverse(
        P, n, L.data_ptr(), X.data_ptr(), dws.data_ptr(),
        torch.cuda.current_stream(L.device).cuda_stream)
    raise_on(rc, "K6b tri_inverse")
    _LAUNCHES.bump("K6B_LAUNCHES")
    return X


def chol_inverse_batched(L):
    """K^-1 = X^T X from Cholesky factors L (P, n, n), X = L^-1 from K6b."""
    X = tri_inverse(L)
    return X.transpose(-1, -2) @ X


class CholCoreFn(torch.autograd.Function):
    """``-0.5 (ym^T K^-1 ym + logdet K)`` per particle: K6a forward, the
    analytic backward of the JAX package's ``pallas_chol.lml_core``."""

    @staticmethod
    def forward(ctx, K, ym):
        L, alpha = chol_solve_batched(K, ym)
        ctx.save_for_backward(L, alpha)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * ((ym * alpha).sum(-1) + logdet)

    @staticmethod
    def backward(ctx, g):
        L, alpha = ctx.saved_tensors
        Kinv = chol_inverse_batched(L)
        # alpha alpha^T - K^-1 cancels to a small matrix; on a near-rank-one
        # K its entries are nearly equal, so float32 products and differences
        # round them all the same way and the covariance VJP's sum over n^2
        # entries carries that bias.  Form it in float64, round once.
        a = alpha.double()
        dK = ((0.5 * g.double())[:, None, None]
              * (a[:, :, None] * a[:, None, :] - Kinv.double()))
        return dK.to(alpha.dtype), -g[:, None] * alpha


def lml_core(K, ym):
    """Batched ``-0.5 (ym^T K^-1 ym + logdet K)`` through K6a/K6b."""
    return CholCoreFn.apply(K.contiguous(), ym.contiguous())


def __getattr__(name):
    if name in _LAUNCHES:
        return _LAUNCHES[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
