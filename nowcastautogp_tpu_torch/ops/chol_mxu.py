"""Batched X = L^-1 of SPD A (L L^T = A): CUDA kernel K3 and its plain version.

``tri_inv(A)`` takes A (P, n, n) and returns the lower-triangular X: K3 on a
CUDA tensor (32 <= n <= 1024, n % 32 == 0, the JAX package's
``mxu_supported``), ``tri_inv_plain`` on a CPU tensor.  On the card it
launches the kernel or raises.  A particle whose factorisation fails is NaN
in its own lane only.  K3 replaces
``nowcastautogp_tpu/ops/chol_mxu.py::_tri_inv_kernel`` (``tri_inv_fused``);
``csrc/chol_mxu.cu`` says what bounds it and how.
"""

from __future__ import annotations

import torch

from .cudalib import LaunchCounter, library, raise_on
from .megalml import cholesky_nan

__all__ = ["tri_inv", "tri_inv_plain", "mxu_supported", "K3_LAUNCHES",
           "reset_launch_counts"]

# Launches of K3, counted where the wrapper launches the kernel; read as
# K3_LAUNCHES.
_LAUNCHES = LaunchCounter("K3_LAUNCHES")

_B = 32
_MAX_N = 1024


def reset_launch_counts() -> None:
    """Set the launch counter to zero."""
    _LAUNCHES.reset()


def mxu_supported(n: int) -> bool:
    """K3's envelope: 32 <= n <= 1024, n a multiple of 32."""
    return _B <= n <= _MAX_N and n % _B == 0


def tri_inv_plain(A):
    """Plain version: ``cholesky_nan`` and a triangular solve against I."""
    L = cholesky_nan(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(A), upper=False)


def tri_inv(A):
    """K3: X = L^-1 with L L^T = A, A (P, n, n) -> X (P, n, n) lower."""
    dev = A.device.type
    if dev == "cpu":
        return tri_inv_plain(A)
    if dev != "cuda":
        raise ValueError(f"no tri_inv kernel for device {A.device}")
    P, n = A.shape[0], A.shape[-1]
    if A.dtype != torch.float32 or tuple(A.shape) != (P, n, n):
        raise ValueError(f"A: expected float32 (P, n, n), got {A.dtype} "
                         f"{tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if not mxu_supported(n):
        raise NotImplementedError(
            f"n={n} is outside K3's envelope (32 <= n <= {_MAX_N}, "
            f"n % {_B} == 0)")
    X = torch.empty_like(A)
    ws = torch.empty_like(A)
    dws = torch.empty((P, n, _B), dtype=torch.float32, device=A.device)
    rc = library().tri_inv(P, n, A.data_ptr(), X.data_ptr(), ws.data_ptr(),
                           dws.data_ptr(),
                           torch.cuda.current_stream(A.device).cuda_stream)
    raise_on(rc, "K3 tri_inv")
    _LAUNCHES.bump("K3_LAUNCHES")
    return X


def __getattr__(name):
    if name in _LAUNCHES:
        return _LAUNCHES[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
