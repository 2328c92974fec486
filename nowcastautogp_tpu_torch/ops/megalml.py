"""Fused masked LML core: CUDA kernels K1/K2, their plain version, autograd.

``lml_core(types, params, diagv, mask, x, ym)`` returns, per particle,
``-0.5 (ym^T A^-1 ym + logdet A)`` with ``A = K(x, x) o (m m^T) +
diag(diagv)``.  It is the fit's LML core up to capacity 512:

* a CPU tensor takes ``lml_core_plain``: the torch interpreter, a Cholesky
  and a triangular solve, differentiated by autograd;
* a CUDA tensor takes ``LmlCoreFn``: the hand-written kernels of
  ``csrc/megalml.cu``.  Its forward launches K1 (value and all gradients)
  when ``params``, ``diagv`` or ``ym`` need a gradient and K2 (value only)
  otherwise; its backward rescales K1's saved gradients, so a gradient
  evaluation costs one K1 call (the factorisation kernel, then the
  backward walk over lower tiles in one launch per heap class or two
  class-switched ones, and its fixed-order tile sum, counted once);
* any other device raises.

On the card there is no fallback: a kernel that does not build, or a shape
outside the kernels' envelope, raises.  The kernels replace the TPU kernels
``nowcastautogp_tpu/ops/pallas_megalml.py::_megalml_kernel`` (K1) and
``::_megalml_val_kernel`` (K2); the source note in ``csrc/megalml.cu`` says
what bounds them and how.

The kernels live in the port's one CUDA library (``ops/cudalib.py``: built
with ``nvcc`` on first use, bound with ``ctypes``).  Capacities above 512
take the composed path instead (``ops/lml.py::lml_core``).
"""

from __future__ import annotations

import torch

from .cudalib import LaunchCounter, library, raise_on
from .kernels import eval_cov_batch

__all__ = [
    "lml_core", "lml_core_plain", "LmlCoreFn", "megalml_val", "megalml_vag",
    "megalml_supported", "cholesky_nan",
    "K1_LAUNCHES", "K2_LAUNCHES", "K1_BWD_LAUNCHES", "reset_launch_counts",
    "vjp_launches", "CLASS_LAUNCH_BLOCKS",
]

# Launches of K1 (value + gradient) and K2 (value only), counted where each
# wrapper launches its kernel and nowhere else; read as K1_LAUNCHES and
# K2_LAUNCHES.  K1_BWD_LAUNCHES counts the backward walk's pass-1 launches
# of those K1 calls (vjp_launches): over K1_LAUNCHES, 1 or 2 for the
# class-switched plan, the number of heap classes for one launch per class.
_LAUNCHES = LaunchCounter("K1_LAUNCHES", "K2_LAUNCHES", "K1_BWD_LAUNCHES")

_HEAP_SIZES = (7, 15, 31, 63)
_MAX_N = 512

# The VJP launch plan of csrc/covtile.cuh (K1's backward walk, K5, K7B):
# one launch per heap class on a grid of at least CLASS_LAUNCH_BLOCKS
# blocks (particles x tiles), else one class-switched launch for classes up
# to REG_CLASS_MAX and one for the larger ones.
CLASS_LAUNCH_BLOCKS = 4096
REG_CLASS_MAX = 15


def reset_launch_counts() -> None:
    """Set the launch counters to zero."""
    _LAUNCHES.reset()


def vjp_launches(n_nodes: int, blocks: int) -> int:
    """Pass-1 launches of a VJP on heaps of ``n_nodes`` slots (a kernel
    size: 7, 15, 31 or 63) over a grid of ``blocks`` blocks (particles x
    tiles), by the kernels' plan; the wrappers count launches with it
    without reading the trees' classes back."""
    if blocks >= CLASS_LAUNCH_BLOCKS:
        return n_nodes.bit_length()    # one per class 1, 3, ..., n_nodes
    return 1 if n_nodes <= REG_CLASS_MAX else 2


def megalml_supported(n_nodes: int, n: int) -> bool:
    """The kernels' envelope: heaps of at most 63 slots, 32 <= n <= 512,
    n a multiple of 32 (the same as the JAX package's fused kernel)."""
    return n_nodes <= _HEAP_SIZES[-1] and 32 <= n <= _MAX_N and n % 32 == 0


def cholesky_nan(A):
    """Lower Cholesky factor with NaN in every lane whose factorisation
    failed (``torch.linalg.cholesky`` raises where JAX returns NaN)."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def lml_core_plain(types, params, diagv, mask, x, ym):
    """Plain torch version of the kernels (any device, autograd gradients)."""
    K = eval_cov_batch(types, params, x, x)
    A = K * (mask[:, :, None] * mask[:, None, :]) + torch.diag_embed(diagv)
    L = cholesky_nan(A)
    t = torch.linalg.solve_triangular(L, ym[..., None], upper=False)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * ((t * t).sum(-1) + logdet)


# ---------------------------------------------------------------- wrappers


def _check_inputs(types, params, diagv, mask, x, ym):
    """Validate the kernels' operands; returns (P, N, n)."""
    if types.device.type != "cuda":
        raise ValueError(f"the LML kernels take CUDA tensors, got {types.device}")
    P, N = types.shape
    n = x.shape[-1]
    expect = {"types": (types, torch.int32, (P, N)),
              "params": (params, torch.float32, (P, N, 3)),
              "diagv": (diagv, torch.float32, (P, n)),
              "mask": (mask, torch.float32, (P, n)),
              "x": (x, torch.float32, (P, n)),
              "ym": (ym, torch.float32, (P, n))}
    for name, (t, dtype, shape) in expect.items():
        if t.device != types.device:
            raise ValueError(f"{name} is on {t.device}, types on {types.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N not in _HEAP_SIZES or not megalml_supported(N, n):
        raise NotImplementedError(
            f"heap size {N} x n={n} is outside the LML kernels' envelope "
            f"(N in {_HEAP_SIZES}, 32 <= n <= {_MAX_N}, n % 32 == 0); "
            "ops/lml.lml_core routes larger capacities to the composed path")
    return P, N, n


def megalml_val(types, params, diagv, mask, x, ym):
    """K2: value-only kernel -> core (P,)."""
    P, N, n = _check_inputs(types, params, diagv, mask, x, ym)
    lib = library()
    dev = types.device
    core = torch.empty(P, dtype=torch.float32, device=dev)
    ws = torch.empty((P, n, n), dtype=torch.float32, device=dev)
    dws = torch.empty((P, n, 32), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.megalml_val(N, P, n, types.data_ptr(), params.data_ptr(),
                         diagv.data_ptr(), mask.data_ptr(), x.data_ptr(),
                         ym.data_ptr(), core.data_ptr(), ws.data_ptr(),
                         dws.data_ptr(), stream)
    raise_on(rc, "K2 megalml_val")
    _LAUNCHES.bump("K2_LAUNCHES")
    return core


def megalml_vag(types, params, diagv, mask, x, ym):
    """K1: value and gradients -> (core (P,), dparams (P, N, 3),
    gdiag (P, n) = d core / d diagv, alpha (P, n) = A^-1 ym)."""
    P, N, n = _check_inputs(types, params, diagv, mask, x, ym)
    lib = library()
    dev = types.device
    core = torch.empty(P, dtype=torch.float32, device=dev)
    dparams = torch.empty((P, N, 3), dtype=torch.float32, device=dev)
    gdiag = torch.empty((P, n), dtype=torch.float32, device=dev)
    alpha = torch.empty((P, n), dtype=torch.float32, device=dev)
    ws1 = torch.empty((P, n, n), dtype=torch.float32, device=dev)
    ws2 = torch.empty((P, n, n), dtype=torch.float32, device=dev)
    dws = torch.empty((P, n, 32), dtype=torch.float32, device=dev)
    tiles = lib.megalml_tiles(n)
    partial = torch.empty((P, tiles, 3 * N), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.megalml_vag(N, P, n, types.data_ptr(), params.data_ptr(),
                         diagv.data_ptr(), mask.data_ptr(), x.data_ptr(),
                         ym.data_ptr(), core.data_ptr(), dparams.data_ptr(),
                         gdiag.data_ptr(), alpha.data_ptr(), ws1.data_ptr(),
                         ws2.data_ptr(), dws.data_ptr(), partial.data_ptr(),
                         stream)
    raise_on(rc, "K1 megalml_vag")
    _LAUNCHES.bump("K1_LAUNCHES")
    _LAUNCHES.bump("K1_BWD_LAUNCHES", vjp_launches(N, P * tiles))
    return core, dparams, gdiag, alpha


def _pad_heap(types, params):
    """Pad the heap axis with empty slots up to the next kernel size."""
    N = types.shape[1]
    Nk = next((s for s in _HEAP_SIZES if s >= N), N)
    if Nk == N:
        return types, params
    pad = Nk - N
    return (torch.nn.functional.pad(types, (0, pad)),
            torch.nn.functional.pad(params, (0, 0, 0, pad)))


class LmlCoreFn(torch.autograd.Function):
    """The kernels as an autograd function: gradients flow to ``params``,
    ``diagv`` and ``ym``; ``types``, ``mask`` and ``x`` are data.
    ``want_grad`` selects K1 over K2 (``lml_core`` sets it from grad mode
    and ``requires_grad``, which ``forward`` itself cannot see)."""

    @staticmethod
    def forward(ctx, want_grad, types, params, diagv, mask, x, ym):
        N = types.shape[1]
        tk, pk = _pad_heap(types.to(torch.int32).contiguous(),
                           params.contiguous())
        args = (tk, pk, diagv.contiguous(), mask.contiguous(),
                x.contiguous(), ym.contiguous())
        if want_grad:
            core, dparams, gdiag, alpha = megalml_vag(*args)
            ctx.save_for_backward(dparams[:, :N], gdiag, alpha)
        else:
            core = megalml_val(*args)
        return core

    @staticmethod
    def backward(ctx, c):
        dparams, gdiag, alpha = ctx.saved_tensors
        return (None, None, c[:, None, None] * dparams, c[:, None] * gdiag,
                None, None, -c[:, None] * alpha)


def lml_core(types, params, diagv, mask, x, ym):
    """Batched masked LML core, dispatched on the device of ``params``."""
    dev = params.device.type
    if dev == "cpu":
        return lml_core_plain(types, params, diagv, mask, x, ym)
    if dev == "cuda":
        want_grad = torch.is_grad_enabled() and (
            params.requires_grad or diagv.requires_grad or ym.requires_grad)
        return LmlCoreFn.apply(want_grad, types, params, diagv, mask, x, ym)
    raise ValueError(f"no LML core for device {params.device}")


def __getattr__(name):
    if name in _LAUNCHES:
        return _LAUNCHES[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
