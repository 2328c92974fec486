"""Batched HMC over per-particle GP hyperparameters.

Port of the JAX package's ``inference/hmc.py``: ``make_batched_potential``
and ``run_hmc`` (its ``_hmc_batched``, with the carried state exposed).
Every tensor carries the leading particle axis, data buffers included.
Inactive parameter slots (empty heap nodes, unused parameter slots) get
zero momentum and zero gradient, so heterogeneous
structures share one batched call.  The potential's value and gradient are
carried across trajectories: a trajectory costs exactly ``n_leapfrog``
gradient evaluations, each one K1 launch on the card.

Randomness (step jitter, momenta, accepts) comes from the ``torch.Generator``
the caller owns, drawn before each trajectory in the order the trajectory
uses it; each leapfrog differentiates a fresh leaf tensor, so autograd
graphs never outlive one evaluation.

One trajectory body (``_trajectory``) runs two ways.  On a CPU tensor,
and on the card where one LML call's memory is too large to keep in a
graph (``_uses_graph``), ``run_hmc`` calls it once a trajectory.
Elsewhere on the card the trajectory is captured once per shape as a CUDA
graph, as is the initial evaluation, and ``run_hmc`` replays it: a
trajectory's ~450 small launches (each gradient's K1 call and the
element-wise work around it) leave the host as one graph launch.  The JAX
package's counterpart is its jitted ``lax.scan`` over trajectories.
"""

from __future__ import annotations

import collections
import threading

import torch

from ..ops import chol, chol_mxu, cov, lml as lml_ops, megacov, megalml
from ..ops.lml import gp_lml_batched
from ..utils.profiling import count, span

__all__ = ["make_batched_potential", "run_hmc"]

# Robbins-Monro adaptation of the per-particle step-size scale: nudge the
# scale after every trajectory toward this target acceptance rate.  The scale
# persists in the model state, so adaptation accumulates across a fit.
_TARGET_ACCEPT = 0.65
_ADAPT_RATE = 0.05
_SCALE_BOUNDS = (0.02, 50.0)

# Captured shapes kept at once, the least recently used evicted beyond it.
# A weekly fit uses about 10, a daily one about 20.
_MAX_GRAPHS = 64
# A captured call keeps its working memory in the graphs' pool for as long
# as its graph is cached, beside the eager calls' own budget of up to
# ``_CHUNK_BYTES`` a call: half that budget leaves the 80 GB card room for
# both (the refresh's 20,000 rows at capacity 160 are budgeted 15.3 GiB).
_GRAPH_BYTES = lml_ops._CHUNK_BYTES // 2


def make_batched_potential(
    node_types, prior_mu, prior_sigma, prior_active,
    x, y, mask, jitter, noise_mu, noise_sigma, infer_noise,
):
    """Batched HMC potential ``(params, log_noise) -> (U, lml)``, each (P,).

    The summed potential decouples into per-particle gradients.
    """
    log_sigma = torch.log(prior_sigma)

    def potential(p, ln):
        lml = gp_lml_batched(node_types, p, ln, x, y, mask, jitter)
        z = (p - prior_mu) / prior_sigma
        lp = (prior_active * (-0.5 * z * z - log_sigma)).sum((1, 2))
        zn = (ln - noise_mu) / noise_sigma
        lp = lp + infer_noise * (-0.5 * zn * zn)
        return -(lml + lp), lml

    return potential


def _value_and_grad(potential, p, ln):
    """(U, lml, dU/dp, dU/dln) at (p, ln), with no graph left behind."""
    with span("lml/grad"):
        p = p.detach().requires_grad_(True)
        ln = ln.detach().requires_grad_(True)
        with torch.enable_grad():
            U, lml = potential(p, ln)
            g_p, g_n = torch.autograd.grad(U.sum(), (p, ln))
        return U.detach(), lml.detach(), g_p, g_n


def _draws(gen, shape, dev, out=(None, None, None, None)):
    """A trajectory's random numbers, in the order it uses them: the step
    jitter (P,), the momenta of the parameters ``shape`` and of the noise
    (P,), the accept (P,).  ``out`` takes them into given buffers."""
    P = shape[0]
    return (torch.rand(P, generator=gen, device=dev, out=out[0]),
            torch.randn(shape, generator=gen, device=dev, out=out[1]),
            torch.randn(P, generator=gen, device=dev, out=out[2]),
            torch.rand(P, generator=gen, device=dev, out=out[3]))


def _trajectory(potential, state, draws, prior_active, *, n_leapfrog,
                step_size, step_jitter, infer_noise):
    """One HMC trajectory of all particles, with its accept and step-size
    adaptation.  ``state`` is ``(p, ln, U, lml, g_p, g_n, scale, n_acc)``
    and the new state is returned in the same order."""
    p, ln, U0, lml, g_p, g_n, scale, n_acc = state
    r_eps, r_mom_p, r_mom_n, u = draws
    with span("hmc/trajectory"):
        eps = step_size * scale * (1.0 + step_jitter * (2.0 * r_eps - 1.0))
        eps3 = eps[:, None, None]
        mom_p = r_mom_p * prior_active
        mom_n = r_mom_n * infer_noise
        K0 = 0.5 * ((mom_p * mom_p).sum((1, 2)) + mom_n * mom_n)

        p_, ln_, mp, mn, gp_, gn_ = p, ln, mom_p, mom_n, g_p, g_n
        U_, lml_ = U0, lml
        for _ in range(n_leapfrog):
            mp = mp - 0.5 * eps3 * gp_ * prior_active
            mn = mn - 0.5 * eps * gn_ * infer_noise
            p_ = p_ + eps3 * mp * prior_active
            ln_ = ln_ + eps * mn * infer_noise
            U_, lml_, gp_, gn_ = _value_and_grad(potential, p_, ln_)
            mp = mp - 0.5 * eps3 * gp_ * prior_active
            mn = mn - 0.5 * eps * gn_ * infer_noise
        K1 = 0.5 * ((mp * mp).sum((1, 2)) + mn * mn)
        dH = (U0 + K0) - (U_ + K1)
        ok = torch.isfinite(dH) & (torch.log(u) < torch.clamp_max(dH, 0.0))
        ok3 = ok[:, None, None]
        p = torch.where(ok3, p_, p)
        ln = torch.where(ok, ln_, ln)
        U0 = torch.where(ok, U_, U0)
        lml = torch.where(ok, lml_, lml)
        g_p = torch.where(ok3, gp_, g_p)
        g_n = torch.where(ok, gn_, g_n)
        okf = ok.to(scale.dtype)
        scale = torch.clamp(
            scale * torch.exp(_ADAPT_RATE * (okf - _TARGET_ACCEPT)),
            *_SCALE_BOUNDS)
        n_acc = n_acc + okf
    return p, ln, U0, lml, g_p, g_n, scale, n_acc


def _uses_graph(device_type: str, P: int, n: int) -> bool:
    """Whether ``run_hmc`` replays captured trajectories: on the card, where
    one LML call's budget (``ops/lml.py``'s ``budget_bytes``) is at most
    ``_GRAPH_BYTES``.  That holds the fused core and the composed core
    within one chunk at the fits' sizes; the chunked composed core, which
    checkpoints its chunks, and larger calls, whose device time hides their
    launches, stay eager."""
    return (device_type == "cuda"
            and lml_ops.budget_bytes(P, n) <= _GRAPH_BYTES)


# ------------------------------------------------ the captured trajectories

# Launch counters of the kernels a trajectory can reach.  Their wrappers
# count a launch when they are called, so a capture bumps them without
# running anything and a replay bumps nothing: the capture's bumps are
# taken back and each replay bumps them again.
_COUNTED = (megalml, megacov, chol_mxu, cov, chol)


def _launch_counts():
    return {(m, name): getattr(m, name) for m in _COUNTED
            for name in m.__all__ if name.endswith("_LAUNCHES")}


def _bump(deltas, sign=1):
    for (m, name), d in deltas.items():
        m._LAUNCHES.bump(name, sign * d)


def _compact(t):
    """The smallest tensor ``t`` expands: its stride-0 axes cut to one."""
    return t[tuple(slice(0, 1) if s == 0 else slice(None)
                   for s in t.stride())]


def _layout(t):
    return (tuple(t.shape), tuple(s == 0 for s in t.stride()), t.dtype)


class _Captured:
    """The static buffers of one key, and its two graphs once captured:
    the initial evaluation and one trajectory, each with the launch counts
    a replay adds.  The state buffers carry a call from one replay to the
    next; no caller's tensor is ever one of them."""

    def __init__(self, inputs, params, dev):
        self.dev = dev
        self.bases = [torch.empty_like(_compact(t),
                                       memory_format=torch.contiguous_format)
                      for t in inputs]
        self.inputs = [b.expand(t.shape) for b, t in zip(self.bases, inputs)]
        P, shape = params.shape[0], params.shape
        vec = lambda: torch.zeros(P, dtype=params.dtype, device=dev)
        self.state = [torch.zeros_like(params), vec(), vec(), vec(),
                      torch.zeros_like(params), vec(), vec(),
                      torch.zeros(P, dtype=torch.float32, device=dev)]
        self.draws = [vec(), torch.zeros(shape, dtype=params.dtype,
                                         device=dev), vec(), vec()]
        self.stream = torch.cuda.Stream(dev)
        self.init = self.step = None

    def load(self, inputs):
        for b, t in zip(self.bases, inputs):
            b.copy_(_compact(t))

    def capture(self, body):
        """Capture ``body`` (which writes its results into ``state``) as a
        graph in the device's pool; returns (graph, launch counts a
        replay adds).  ``body`` runs once eagerly first, on the calling
        stream with its results dropped, so lazy set-up (the kernel
        library, the autograd engine's device threads, library handles)
        happens outside the capture.  Neither run counts its launches."""
        before = _launch_counts()
        body(False)
        cur = torch.cuda.current_stream(self.dev)
        self.stream.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            mid = _launch_counts()
            graph.capture_begin(pool=_pool(self.dev))
            try:
                body(True)
            finally:
                graph.capture_end()
        cur.wait_stream(self.stream)
        after = _launch_counts()
        _bump({k: after[k] - before[k] for k in after}, -1)
        count("hmc/graph_captures", 1)
        return graph, {k: after[k] - mid[k] for k in after
                       if after[k] != mid[k]}

    def replay(self, captured):
        graph, deltas = captured
        graph.replay()
        _bump(deltas)


_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_LOCK = threading.Lock()


def _pool(dev):
    """The memory pool every cached graph on ``dev`` shares: their replays
    run one at a time on one stream, and every result lives outside the
    pool, so the pool holds the largest capture's memory, not the sum.  A
    pool whose graphs are all gone cannot take a capture: a new one
    starts."""
    for entry in _GRAPHS.values():
        for captured in (entry.init, entry.step):
            if entry.dev == dev and captured is not None:
                return captured[0].pool()
    return torch.cuda.graph_pool_handle()


def _hmc_graphed(inputs, params, log_noise, gen, eps_scale, init, n_steps,
                 key, potential_of, traj_kw):
    dev = params.device
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _GRAPHS[key] = _Captured(inputs, params, dev)
        if len(_GRAPHS) > _MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    st = entry.state
    with torch.no_grad():
        entry.load(inputs)
        st[0].copy_(params)
        st[1].copy_(log_noise)
        if init is None:
            if entry.init is None:
                def first(write):
                    new = _value_and_grad(potential_of(entry.inputs),
                                          st[0], st[1])
                    if write:
                        for dst, src in zip(st[2:6], new):
                            dst.copy_(src)
                entry.init = entry.capture(first)
            entry.replay(entry.init)
        else:
            for dst, src in zip(st[2:6], init):
                dst.copy_(src)
        if eps_scale is None:
            st[6].fill_(1.0)
        else:
            st[6].copy_(eps_scale)
        st[7].zero_()
        for _ in range(n_steps):
            _draws(gen, params.shape, dev, out=entry.draws)
            if entry.step is None:
                def step(write):
                    new = _trajectory(potential_of(entry.inputs), st,
                                      entry.draws, entry.inputs[3],
                                      **traj_kw)
                    if write:
                        for dst, src in zip(st, new):
                            dst.copy_(src)
                entry.step = entry.capture(step)
            entry.replay(entry.step)
    count("hmc/graph_replays", n_steps)
    return [t.clone() for t in st]


def run_hmc(
    node_types, params, log_noise, prior_mu, prior_sigma, prior_active,
    x, y, mask, gen, *, n_steps, n_leapfrog, step_size, step_jitter,
    jitter, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0, eps_scale=None,
    init=None,
):
    """``n_steps`` HMC trajectories for all particles, with the carried
    state exposed (the JAX package's ``_hmc_batched``).

    ``init``, when given, is ``(U0, lml0, g_p0, g_n0)``: the potential, LML
    and gradients already evaluated at ``(params, log_noise)``, and the
    initial evaluation is skipped (the device sweep carries them across
    moves).  Returns ``(params, log_noise, lml, accept_rate (P,), eps_scale,
    (U, g_p, g_n))``, the last the final state's potential and gradients,
    valid for the same carrying.  On the card (``_uses_graph``) the
    returned tensors are new, and the graphs' buffers hold copies of the
    arguments, never the arguments.
    """
    with span("hmc/run"):
        P = params.shape[0]
        dev = params.device
        traj_kw = dict(n_leapfrog=n_leapfrog, step_size=step_size,
                       step_jitter=step_jitter, infer_noise=infer_noise)

        def potential_of(data):
            return make_batched_potential(*data, jitter, noise_mu,
                                          noise_sigma, infer_noise)

        data = (node_types, prior_mu, prior_sigma, prior_active, x, y, mask)
        if _uses_graph(dev.type, P, x.shape[-1]):
            key = (dev, lml_ops._LML_BACKEND, cov._COV_BACKEND,
                   torch.backends.cuda.matmul.allow_tf32,
                   tuple(_layout(t) for t in (params, log_noise) + data),
                   n_leapfrog, step_size, step_jitter, jitter, noise_mu,
                   noise_sigma, infer_noise)
            with _LOCK:
                p, ln, U0, lml, g_p, g_n, scale, n_acc = _hmc_graphed(
                    data, params, log_noise, gen, eps_scale, init, n_steps,
                    key, potential_of, traj_kw)
        else:
            potential = potential_of(data)
            if eps_scale is None:
                eps_scale = torch.ones(P, dtype=params.dtype, device=dev)
            if init is None:
                U0, lml, g_p, g_n = _value_and_grad(potential, params,
                                                    log_noise)
            else:
                U0, lml, g_p, g_n = init
            state = (params.detach(), log_noise.detach(), U0, lml, g_p, g_n,
                     eps_scale, torch.zeros(P, dtype=torch.float32,
                                            device=dev))
            for _ in range(n_steps):
                state = _trajectory(potential, state,
                                    _draws(gen, params.shape, dev),
                                    prior_active, **traj_kw)
            count("hmc/eager_trajectories", n_steps)
            p, ln, U0, lml, g_p, g_n, scale, n_acc = state
        rate = n_acc / max(n_steps, 1)
        return p, ln, lml, rate, scale, (U0, g_p, g_n)
