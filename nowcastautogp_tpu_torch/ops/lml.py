"""Masked log marginal likelihood and GP predictive posterior, batched.

Port of the JAX package's ``ops/lml.py``.  Every op takes a fixed-capacity
``(P, n_cap)`` data buffer plus a {0,1} ``mask``: masked rows and columns of
the covariance become identity rows, so the Cholesky factor carries exact
zeros and ones there and the log-determinant and quadratic form reduce to
the active subset.  A particle whose LML is not finite gets ``-1e10``, so
SMC weights and MH accepts treat a numerically broken proposal as
rejected.

The LML core (``lml_core``) is chosen by capacity n, the same way on both
devices, so the CPU tests run the glue the card runs:

* n <= 512: the fused core of ``ops/megalml.py`` (K1/K2 on a CUDA tensor,
  their plain version on a CPU tensor);
* n > 512: the composed core, the JAX package's ``_lml_from_K`` path:
  K(x, x) from ``CovFn`` (K4 forward, K5 backward), the masked A, then
  ``InvCoreFn`` (K3's X = L^-1 for n <= 1024, the JAX ``"inv"`` form of
  ``cholesky_nan`` and a triangular solve above), whose backward is the
  analytic dA = c/2 (alpha alpha^T - A^-1), dym = -c alpha.  It holds a
  few (n, n) planes a particle, so it runs over chunks of particles under
  a byte budget (``composed_chunk``): at P = 200 a float32 plane is 0.27 GB
  at n = 576 but 3.9 GB at n = 2,208.  Beyond 2048 the JAX package runs the
  same function through its interpreter and an XLA Cholesky; the port runs
  K4/K5 up to their envelope's 4096 and raises beyond it on the card.

That is the default LML backend ("auto", or "mega": the JAX package's
names).  ``set_lml_backend("pallas")`` selects the JAX package's opt-in
``"pallas"`` branch instead: A = ``masked_kernel_matrix`` (its K through
``cov_fn``, so K7F/K7B under the "pallas" covariance backend and K4/K5
under "jnp"), then the blocked Cholesky core of ``ops/chol.py`` (K6a in
the forward, K6b in the backward).

At one shape the value path and the gradient path use the same core, so
both sides of every comparison the fit makes (MH logits, reweight deltas,
values carried out of HMC) come from one numerical core.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from . import chol, megalml
from .chol_mxu import mxu_supported, tri_inv
from .cov import cov_fn
from .megacov import cov_batched
from .megalml import cholesky_nan

__all__ = [
    "masked_kernel_matrix", "gp_lml_batched", "gp_predict_batch",
    "gp_predict_batch_rows", "sampling_cholesky", "lml_core",
    "lml_core_composed", "composed_chunk", "budget_bytes", "budget_rows",
    "InvCoreFn", "set_lml_backend", "LOG_2PI", "DEFAULT_JITTER",
]

LOG_2PI = 1.8378770664093453
DEFAULT_JITTER = 1e-5

# The byte budget of batched work on the card, shared with the nowcast's
# scenario chunks and the panel's rows.  A row (a particle) is budgeted at
# 8 (cap, cap) float32 matrices: K1's two workspaces and K2's one; the
# composed core's K, A, its mask plane, L, L^-1, A^-1 and its float64
# cotangent.  A call is budgeted at 32 GiB of the H100's 80 GB.
# chip_smoke.py measures the peak where the budget binds: the nowcast
# refresh at capacity 576 (phase 6) and the composed core at n = 4,096
# (phase 8).
_ROW_MATRICES = 8
_CHUNK_BYTES = 32 * 2**30


def budget_bytes(rows: int, cap: int) -> int:
    """The bytes a batched call of ``rows`` rows at capacity ``cap`` is
    budgeted: ``_ROW_MATRICES`` (cap, cap) float32 matrices a row."""
    return rows * _ROW_MATRICES * cap * cap * 4


def budget_rows(cap: int) -> int:
    """The rows at capacity ``cap`` that one call's ``_CHUNK_BYTES`` holds:
    0 where one row alone exceeds it."""
    return _CHUNK_BYTES // budget_bytes(1, cap)

_LML_BACKEND = "auto"


def set_lml_backend(name: str) -> None:
    """Select the LML backend, read at call time: "auto" or "mega" (the
    dispatch by capacity of ``lml_core``) or "pallas" (the blocked Cholesky
    core, K6a/K6b).  The JAX package's "jnp" would put the plain versions on
    the card's path and is not ported."""
    global _LML_BACKEND
    if name == "jnp":
        raise NotImplementedError(
            'the "jnp" LML backend is not ported (ROADMAP.md); use "auto", '
            '"mega" or "pallas"')
    if name not in ("auto", "mega", "pallas"):
        raise ValueError(f"LML backend {name!r}; expected one of "
                         "('auto', 'mega', 'pallas')")
    _LML_BACKEND = name


def masked_kernel_matrix(node_types, params, log_noise, x, mask,
                         jitter=DEFAULT_JITTER):
    """K(x,x) + (noise+jitter)·I on active rows, identity on masked rows.

    Batched: node_types (P, N), params (P, N, 3), log_noise (P,), x and mask
    (P, n) or a shared (n,).  Returns (P, n, n).  K(x, x) comes from
    ``cov_fn``: K4 on the card under the default covariance backend, K7F
    under "pallas".
    """
    K = cov_fn(node_types, params, x)
    mm = mask[..., :, None] * mask[..., None, :]
    diag = mask * (torch.exp(log_noise)[:, None] + jitter) + (1.0 - mask)
    return K * mm + torch.diag_embed(diag)


def _tri_inv_inv_form(A):
    """X = L^-1 by ``cholesky_nan`` and a triangular solve against I: the
    JAX package's ``"inv"`` form (``_ainv_logdet_xla``).  The reference runs
    no kernel for it, so neither does the port: it is chosen by shape, on
    both devices, where K3's envelope ends (n > 1024, or n not a multiple
    of 32), never as a fallback from a failed launch."""
    L = cholesky_nan(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(A), upper=False)


def _ainv_logdet(A):
    """A -> (A^-1, logdet A) from X = L^-1, the form chosen by shape as the
    JAX package's ``lml_core_from_A`` chooses it: K3 inside its envelope
    (``_ainv_logdet_mxu``), else the ``"inv"`` form.  A^-1 = X^T X and, as
    diag(L^-1) = 1 / diag(L), logdet A = -2 sum log diag X."""
    X = tri_inv(A) if mxu_supported(A.shape[-1]) else _tri_inv_inv_form(A)
    logdet = -2.0 * torch.log(torch.diagonal(X, dim1=-2, dim2=-1)).sum(-1)
    return X.transpose(-1, -2) @ X, logdet


class InvCoreFn(torch.autograd.Function):
    """``-0.5 (ym^T A^-1 ym + logdet A)`` per particle with the analytic
    backward of the JAX package's ``_make_inv_core``: from the saved
    (A^-1, alpha), dA = c/2 (alpha alpha^T - A^-1) and dym = -c alpha, with
    no autograd through the factorisation.  A non-SPD lane is NaN and the
    caller's guard rejects it."""

    @staticmethod
    def forward(ctx, A, ym):
        Ainv, logdet = _ainv_logdet(A)
        alpha = (Ainv @ ym[..., None])[..., 0]
        ctx.save_for_backward(Ainv, alpha)
        return -0.5 * ((ym * alpha).sum(-1) + logdet)

    @staticmethod
    def backward(ctx, c):
        Ainv, alpha = ctx.saved_tensors
        # alpha alpha^T - A^-1 cancels to a small matrix; on a near-rank-one
        # A its entries are nearly equal, so float32 products and differences
        # round them all the same way and the covariance VJP's sum over n^2
        # entries carries that bias.  Form it in float64, round once.  Two
        # passes over P n^2 elements (the difference in float64, then the
        # scale rounded into A's dtype), not CholCoreFn's five: at n = 576
        # those cost a tenth of the composed core's value + gradient.
        a = alpha.double()
        diff = torch.addcmul(Ainv, a[:, :, None], a[:, None, :], value=-1)
        dA = torch.mul(diff, (-0.5 * c.double())[:, None, None],
                       out=torch.empty_like(Ainv))
        return dA, -c[:, None] * alpha


def lml_core_composed(types, params, diagv, mask, x, ym):
    """The composed core (the JAX package's ``_lml_from_K``): K from
    ``CovFn``, A = K o (m m^T) + diag(diagv), then ``InvCoreFn``."""
    K = cov_batched(types, params, x)
    A = K * (mask[:, :, None] * mask[:, None, :]) + torch.diag_embed(diagv)
    return InvCoreFn.apply(A, ym)


def composed_chunk(n: int) -> int:
    """Particles per composed-core call at capacity n: as many as one
    call's budget holds (``budget_rows``).  A particle that alone exceeds
    the budget raises."""
    chunk = budget_rows(n)
    if chunk == 0:
        raise ValueError(
            f"one particle at capacity n={n} needs "
            f"{budget_bytes(1, n) / 2**30:.1f} GiB ({_ROW_MATRICES} (n, n) "
            f"float32 planes), above the {_CHUNK_BYTES / 2**30:.0f} GiB "
            "budget of one call")
    return chunk


def lml_core(types, params, diagv, mask, x, ym):
    """Batched ``-0.5 (ym^T A^-1 ym + logdet A)`` with A = K(x, x) o (m m^T)
    + diag(diagv), dispatched by capacity (module docstring).  The composed
    core runs one call per chunk of ``composed_chunk(n)`` particles, so the
    value and the gradient at one shape take the same chunks.  Where a
    gradient is wanted each chunk is checkpointed: it keeps only its inputs
    for the backward, which recomputes its planes one chunk at a time, so
    the chunks' saved planes (A^-1 and the mask product a particle) never
    pile up beyond one chunk's."""
    n = x.shape[-1]
    if n <= megalml._MAX_N:
        return megalml.lml_core(types, params, diagv, mask, x, ym)
    chunk = composed_chunk(n)
    P = params.shape[0]
    if P <= chunk:
        return lml_core_composed(types, params, diagv, mask, x, ym)
    args = (types, params, diagv, mask, x, ym)
    parts = []
    for i in range(0, P, chunk):
        part = tuple(a[i:i + chunk] for a in args)
        parts.append(checkpoint(lml_core_composed, *part, use_reentrant=False)
                     if torch.is_grad_enabled() else lml_core_composed(*part))
    return torch.cat(parts)


def gp_lml_batched(node_types, params, log_noise, x, y, mask,
                   jitter=DEFAULT_JITTER):
    """Masked LML of P particles -> (P,), with the ``-1e10`` guard.

    The diagonal augmentation and ``y * mask`` are built here, so their
    chain rules (d diag / d log_noise = mask·noise, d ym / d y = mask) compose
    with the core's gradients for ``diagv`` and ``ym``.  A call with grad
    mode off is one ``lml/value`` span; with it on, the caller's
    ``lml/grad`` (``inference/hmc.py::_value_and_grad``) holds the call.
    """
    if torch.is_grad_enabled():
        return _lml_batched(node_types, params, log_noise, x, y, mask,
                            jitter)
    with span("lml/value"):
        return _lml_batched(node_types, params, log_noise, x, y, mask,
                            jitter)


def _lml_batched(node_types, params, log_noise, x, y, mask, jitter):
    P, n = params.shape[0], x.shape[-1]
    mask = mask.expand(P, n)
    ym = y.expand(P, n) * mask
    if _LML_BACKEND == "pallas":
        A = masked_kernel_matrix(node_types, params, log_noise, x, mask,
                                 jitter)
        core = chol.lml_core(A, ym)
    else:
        diagv = mask * (torch.exp(log_noise)[:, None] + jitter) + (1.0 - mask)
        core = lml_core(node_types, params, diagv, mask, x.expand(P, n), ym)
    lml = core - 0.5 * mask.sum(-1) * LOG_2PI
    return torch.where(torch.isfinite(lml), lml, torch.full_like(lml, -1e10))


def gp_predict_batch(node_types, params, log_noise, x, y, mask, xs,
                     jitter=DEFAULT_JITTER, include_noise=True):
    """Predictive posterior N(mu, cov) of P particles at test points ``xs``.

    The predictive is over *observations*: the observation-noise variance is
    added to the covariance diagonal when ``include_noise``.  Returns
    mu (P, m) and cov (P, m, m).
    """
    P = params.shape[0]
    A = masked_kernel_matrix(node_types, params, log_noise, x, mask, jitter)
    L = cholesky_nan(A)
    mask = mask.expand(P, A.shape[-1])
    ym = (y.expand(P, A.shape[-1]) * mask)[..., None]
    alpha = torch.cholesky_solve(ym, L)                          # (P, n, 1)
    Ks = cov_fn(node_types, params, x, xs) * mask[..., :, None]
    Kss = cov_fn(node_types, params, xs, xs)
    mu = (Ks.transpose(-1, -2) @ alpha)[..., 0]
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    cov = Kss - V.transpose(-1, -2) @ V
    extra = (torch.exp(log_noise) if include_noise
             else torch.zeros_like(log_noise)) + jitter
    eye = torch.eye(xs.shape[-1], dtype=cov.dtype, device=cov.device)
    return mu, cov + extra[:, None, None] * eye


def gp_predict_batch_rows(node_types, params, log_noise, x, y, mask, xs,
                          jitter=DEFAULT_JITTER, include_noise=True):
    """``gp_predict_batch`` with row-varying test points: ``xs`` is (R, m),
    each row its own (the panel forecast's flattened series x particle
    rows, where every series has its own time normalisation)."""
    if xs.dim() != 2 or xs.shape[0] != params.shape[0]:
        raise ValueError(f"xs must be (R, m) with R = {params.shape[0]}, "
                         f"got {tuple(xs.shape)}")
    return gp_predict_batch(node_types, params, log_noise, x, y, mask, xs,
                            jitter, include_noise)


def sampling_cholesky(cov):
    """Guaranteed-PSD sampling factor for (..., m, m) predictive covariances.

    Large-amplitude particles can make ``Kss - V^T V`` indefinite in f32;
    negative eigenvalues are clamped and ``A = V sqrt(w)`` is returned (any
    square root samples the same Gaussian).  A broken particle (a NaN
    factor, weight -1e10, never drawn) gets an identity covariance: torch's
    ``eigh`` raises on NaN input where JAX's returns NaN.
    """
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    finite = torch.isfinite(cov).all(-1).all(-1)[..., None, None]
    cov = torch.where(finite, cov, eye)
    c = 0.5 * (cov + cov.transpose(-1, -2))
    w, V = torch.linalg.eigh(c)
    scale = torch.clamp_min(w.abs().amax(-1, keepdim=True), 1.0)
    w = torch.maximum(w, 1e-8 * scale)
    return V * torch.sqrt(w)[..., None, :]
