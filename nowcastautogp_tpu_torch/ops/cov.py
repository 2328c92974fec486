"""One tree's covariance K(x1, x2) per particle: CUDA kernels K7F/K7B.

* ``cov_fwd(types, params, x1, x2)`` -> K (P, n, m): K7F on a CUDA tensor,
  the torch interpreter (``eval_cov_batch``) on a CPU tensor;
* ``cov_bwd(types, params, x1, x2, dK)`` -> dparams (P, N, 3), the VJP for
  a general cotangent (no symmetry assumed): K7B on a CUDA tensor, the
  interpreter's autograd VJP on a CPU tensor;
* ``eval_cov_fused`` joins them as an autograd function (gradients reach
  ``params`` only; ``types`` and x are data), the counterpart of the JAX
  package's ``ops/pallas_cov.py::eval_cov_fused`` with the particle axis
  written out;
* ``cov_fn`` and ``set_cov_backend``, the covariance backend every
  covariance of the port goes through (the JAX package's names, from its
  ``ops/kernels.py``).

x1 is (P, n) or a shared (n,), x2 (P, m) or a shared (m,); a row-expanded
view counts as shared.  When x2 is x1 (``_symmetric``: the same tensor, or
views of one buffer with the same shape and strides; values are never
compared) the kernels walk only the lower triangle of K(x, x); each tree
only as far as its heap class (``heap_class``).  The envelope is
1 <= n, m <= ``MAX_FUSED_N`` = 512, the JAX package's; ``cov_fn`` sends
larger shapes to the interpreter by shape, as the JAX package does.  On a
CUDA tensor the wrappers launch their kernel or raise.  The kernels replace
``pallas_cov.py::_cov_fwd_kernel`` (K7F) and ``::_cov_bwd_kernel`` (K7B);
``csrc/cov.cu`` says what bounds them and how.
"""

from __future__ import annotations

import torch

from .cudalib import LaunchCounter, library, raise_on
from .kernels import eval_cov_batch
from .megacov import cov_batched
from .megalml import _HEAP_SIZES, _pad_heap

__all__ = [
    "cov_fwd", "cov_bwd", "cov_fwd_plain", "cov_bwd_plain", "eval_cov_fused",
    "CovFusedFn", "fused_supported", "heap_class", "MAX_FUSED_N",
    "K7F_LAUNCHES", "K7B_LAUNCHES", "reset_launch_counts", "cov_fn",
    "set_cov_backend",
]

# Launches of K7F and K7B, counted where each wrapper launches its kernel;
# read as K7F_LAUNCHES and K7B_LAUNCHES.
_LAUNCHES = LaunchCounter("K7F_LAUNCHES", "K7B_LAUNCHES")

MAX_FUSED_N = 512

_COV_BACKENDS = ("auto", "pallas", "jnp")
_COV_BACKEND = "jnp"


def reset_launch_counts() -> None:
    """Set both launch counters to zero."""
    _LAUNCHES.reset()


def fused_supported(n: int, m: int) -> bool:
    """The kernels' envelope in the points: 1 <= n, m <= 512."""
    return 1 <= n <= MAX_FUSED_N and 1 <= m <= MAX_FUSED_N


def heap_class(types):
    """Each tree's heap class, the kernels' rule: the smallest complete heap
    (1, 3, 7, ... slots) that holds every live slot of its row of ``types``
    (P, N); an empty tree is class 1.  Heap slots are level ordered, so the
    first class slots hold the whole tree.  Returns int64 (P,)."""
    N = types.shape[-1]
    slot = torch.arange(N, device=types.device)
    top = torch.where(types != 0, slot, -1).amax(-1)
    cls = torch.ones_like(top)
    while bool((top >= cls).any()):
        cls = torch.where(top >= cls, 2 * cls + 1, cls)
    return cls


def cov_fwd_plain(types, params, x1, x2):
    """Plain version of K7F: the torch interpreter."""
    return eval_cov_batch(types, params, x1, x2)


def cov_bwd_plain(types, params, x1, x2, dK):
    """Plain version of K7B: the interpreter's VJP of a general dK."""
    with torch.enable_grad():
        p = params.detach().requires_grad_(True)
        K = eval_cov_batch(types, p, x1, x2)
        (g,) = torch.autograd.grad((K * dK).sum(), p)
    return g


def _symmetric(x1, x2) -> bool:
    """True when x2 is x1: the same tensor, or views of one buffer at the
    same offset with the same shape and strides.  Decided from the operands
    before any copy; equal values in distinct buffers do not count."""
    return x2 is x1 or (x1.device == x2.device
                        and x1.data_ptr() == x2.data_ptr()
                        and x1.shape == x2.shape
                        and x1.stride() == x2.stride())


def _points(x):
    """x as the kernels take it: (contiguous buffer, row stride), where a
    1-D or row-expanded x is shared (stride 0)."""
    if x.dim() == 2 and x.stride(0) == 0:
        x = x[0]
    x = x.contiguous()
    return x, (0 if x.dim() == 1 else x.shape[-1])


def _check(types, params, x1, x2, dK=None):
    """Validate the kernels' operands; returns (P, N, n, m)."""
    P, N = types.shape
    n, m = x1.shape[-1], x2.shape[-1]
    expect = {"types": (types, torch.int32, (P, N)),
              "params": (params, torch.float32, (P, N, 3)),
              "x1": (x1, torch.float32, (P, n) if x1.dim() == 2 else (n,)),
              "x2": (x2, torch.float32, (P, m) if x2.dim() == 2 else (m,))}
    if dK is not None:
        expect["dK"] = (dK, torch.float32, (P, n, m))
    for name, (t, dtype, shape) in expect.items():
        if t.device != types.device:
            raise ValueError(f"{name} is on {t.device}, types on {types.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N not in _HEAP_SIZES or not fused_supported(n, m):
        raise NotImplementedError(
            f"heap size {N} x ({n}, {m}) points is outside the fused "
            f"covariance kernels' envelope (N in {_HEAP_SIZES}, "
            f"1 <= n, m <= {MAX_FUSED_N})")
    return P, N, n, m


def _device(types):
    dev = types.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no covariance kernel for device {types.device}")
    return dev


def cov_fwd(types, params, x1, x2):
    """K7F: K(x1_p, x2_p) -> (P, n, m)."""
    if _device(types) == "cpu":
        return cov_fwd_plain(types, params, x1, x2)
    sym = _symmetric(x1, x2)
    (x1, s1), (x2, s2) = _points(x1), _points(x2)
    P, N, n, m = _check(types, params, x1, x2)
    K = torch.empty((P, n, m), dtype=torch.float32, device=types.device)
    rc = library().cov_fwd(
        N, P, n, m, s1, s2, int(sym), types.data_ptr(), params.data_ptr(),
        x1.data_ptr(), (x1 if sym else x2).data_ptr(), K.data_ptr(),
        torch.cuda.current_stream(types.device).cuda_stream)
    raise_on(rc, "K7F cov_fwd")
    _LAUNCHES.bump("K7F_LAUNCHES")
    return K


def cov_bwd(types, params, x1, x2, dK):
    """K7B: cotangent dK (P, n, m) -> dparams (P, N, 3)."""
    if _device(types) == "cpu":
        return cov_bwd_plain(types, params, x1, x2, dK)
    sym = _symmetric(x1, x2)
    (x1, s1), (x2, s2) = _points(x1), _points(x2)
    P, N, n, m = _check(types, params, x1, x2, dK)
    lib = library()
    dev = types.device
    dparams = torch.empty((P, N, 3), dtype=torch.float32, device=dev)
    partial = torch.empty((P, lib.cov_tiles(n, m, int(sym)), 3 * N),
                          dtype=torch.float32, device=dev)
    rc = lib.cov_bwd(
        N, P, n, m, s1, s2, int(sym), types.data_ptr(), params.data_ptr(),
        x1.data_ptr(), (x1 if sym else x2).data_ptr(), dK.data_ptr(),
        dparams.data_ptr(), partial.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(rc, "K7B cov_bwd")
    _LAUNCHES.bump("K7B_LAUNCHES")
    return dparams


class CovFusedFn(torch.autograd.Function):
    """K7F forward, K7B backward; gradients flow to ``params`` only.
    Heaps arrive padded to a kernel size and contiguous."""

    @staticmethod
    def forward(ctx, types, params, x1, x2):
        ctx.save_for_backward(types, params, x1, x2)
        return cov_fwd(types, params, x1, x2)

    @staticmethod
    def backward(ctx, dK):
        types, params, x1, x2 = ctx.saved_tensors
        return (None, cov_bwd(types, params, x1, x2, dK.contiguous()), None,
                None)


def eval_cov_fused(types, params, x1, x2):
    """Differentiable K(x1, x2) of P trees -> (P, n, m) through K7F/K7B.

    types (P, N) heap encoding, params (P, N, 3), x1 (P, n) or (n,), x2
    (P, m) or (m,).
    """
    tk, pk = _pad_heap(types.to(torch.int32).contiguous(), params.contiguous())
    return CovFusedFn.apply(tk, pk, x1, x2)


# ---------------------------------------------------------------------------
# Covariance backend, the JAX package's ``set_cov_backend``/``cov_fn``:
#   "jnp"    (default) K(x, x) of a data buffer from K4 (``ops/megacov.py``),
#            every other covariance from the interpreter (``ops/kernels.py``);
#   "pallas" every K(x1, x2) with max(n, m) <= 512 from K7F/K7B above,
#            larger ones from the interpreter, chosen by shape as the JAX
#            package chooses;
#   "auto"   "pallas" on a CUDA tensor, else "jnp".
# Read at call time.
# ---------------------------------------------------------------------------


def set_cov_backend(name: str) -> None:
    """Select the covariance backend: "auto", "pallas" or "jnp"."""
    global _COV_BACKEND
    if name not in _COV_BACKENDS:
        raise ValueError(f"covariance backend {name!r}; expected one of "
                         f"{_COV_BACKENDS}")
    _COV_BACKEND = name


def _use_fused(device) -> bool:
    return _COV_BACKEND == "pallas" or (_COV_BACKEND == "auto"
                                        and device.type == "cuda")


def cov_fn(node_types, params, x1, x2=None):
    """Covariances of P trees through the active backend -> (P, n, m).

    Shapes as ``eval_cov_batch``.  ``x2=None`` asks for K(x1, x1) of a data
    buffer, which the "jnp" backend takes from K4 (``cov_batched``, the
    symmetric kernel with its own envelope); any explicit ``x2`` is a
    general K(x1, x2).  Differentiable in ``params``.
    """
    xb = x1 if x2 is None else x2
    if _use_fused(params.device):
        if fused_supported(x1.shape[-1], xb.shape[-1]):
            return eval_cov_fused(node_types, params, x1, xb)
    elif x2 is None:
        return cov_batched(node_types, params, x1)
    return eval_cov_batch(node_types, params, x1, xb)


def __getattr__(name):
    if name in _LAUNCHES:
        return _LAUNCHES[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
