"""Several cards from one process: a 1-D mesh and row-sharded SMC steps.

Port of the JAX package's ``parallel/sharding.py``.  Per-series GP work
needs no communication across rows, so JAX runs each shard of the row
axis as its own single-device program (``jax.shard_map``).  The port does
the same as a single controller: one process drives every card of a
``Mesh``, as one JAX process drives its mesh.  The state of a call lives
on the mesh's first device; each wrapper

* splits the row arrays into contiguous shards (the rule of
  ``shard_rows``) and copies each to its device;
* runs the single-card body (``gp_lml_batched``, ``run_hmc``,
  ``rejuvenation_sweep``, ``nowcast_forecast_hmc_scan``, the host engine's
  move body) for each shard in turn, in the calling thread, under
  ``torch.cuda.device`` of the shard's card.  The bodies read nothing
  back, so a card runs its shard's queue while the host launches the
  next shard's.  Not one host thread a shard or a card: every torch call
  releases and retakes the interpreter lock, and with several threads
  contending for it the hand-overs cost more than the host work itself
  (the panel fit of ``chip_smoke.py``: 11.1 s unsharded, 41.9 s as 4
  shards in turn on one H100, 120.7 s with a thread a shard, 141.0 s on
  four H100s with a thread a card; PERF.md);
* re-raises the first failing shard's exception, and concatenates the
  results on the first device.

Randomness: each shard draws from its own ``torch.Generator`` on its own
device, seeded from one draw of the caller's generator and the shard
index (``shard_seeds``), the counterpart of JAX's
``jax.random.fold_in(key, axis_index)``.  The streams therefore differ
from the unsharded call's at the same seed; per shard the wrappers are
exactly the single-card body on the shard's rows with the shard's
generator (``tests/test_torch_sharding.py``).

A ``Mesh`` may name one device several times: each entry is one shard.
That is how the CPU tests, and ``chip_smoke.py`` on a machine with one
card, run several shards through the same code.
"""

from __future__ import annotations

import contextlib
import hashlib

import torch

from ..inference.device_smc import rejuvenation_sweep
from ..inference.hmc import run_hmc
from ..inference.structure_mcmc import _structure_move_body
from ..ops.forecast_scan import nowcast_forecast_hmc_scan
from ..ops.lml import DEFAULT_JITTER, gp_lml_batched

__all__ = [
    "Mesh", "make_mesh", "shard_rows", "shard_seeds", "panel_smc_step",
    "lml_rows_sharded", "structure_move_sharded", "run_hmc_sharded",
    "rejuvenation_sweep_sharded", "forecast_hmc_scan_sharded",
]


class Mesh:
    """A 1-D mesh: the devices the rows are split over, in order, and the
    name of that axis.  ``devices[i]`` holds shard i; a device may
    repeat."""

    def __init__(self, devices, axis_name: str = "series"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def device_share(self) -> float:
        """The largest share of the rows that one device holds."""
        return max(self.devices.count(d) for d in self.devices) / self.size

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


def make_mesh(n_devices: int | None = None,
              axis_name: str = "series") -> Mesh:
    """1-D ``Mesh`` over the first ``n_devices`` visible CUDA devices (all
    of them by default), as the JAX package takes ``jax.devices()[:n]``.
    Raises where no card is visible: build a ``Mesh`` of CPU devices
    directly for a rehearsal."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is visible")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} devices asked, {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis_name)


def _map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map_tree(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    return tree


def _split(a, mesh: Mesh, i: int):
    """Shard i of a row tensor, on its device."""
    k = a.shape[0] // mesh.size
    return a[i * k:(i + 1) * k].to(mesh.devices[i])


def shard_rows(tree, mesh: Mesh):
    """Per-shard copies of ``tree``: a list of ``mesh.size`` trees, where a
    tensor whose leading (row) axis divides the mesh is split into
    contiguous shards and any other tensor is replicated, each on its
    shard's device (the JAX package's placement rule)."""
    def put(i):
        def one(a):
            if a.dim() >= 1 and a.shape[0] % mesh.size == 0:
                return _split(a, mesh, i)
            return a.to(mesh.devices[i])
        return _map_tree(one, tree)
    return [put(i) for i in range(mesh.size)]


def _fold_in(seed: int, i: int) -> int:
    h = hashlib.sha256(int(seed).to_bytes(8, "little")
                       + int(i).to_bytes(8, "little"))
    return int.from_bytes(h.digest()[:8], "little") >> 1


def shard_seeds(gen: torch.Generator, mesh: Mesh) -> list[int]:
    """One seed a shard: one draw of ``gen`` (advancing it, as JAX splits
    its key) folded with each shard index."""
    base = int(torch.randint(0, 2**62, (1,), generator=gen,
                             device=gen.device).item())
    return [_fold_in(base, i) for i in range(mesh.size)]


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _on_device(device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _on_shards(mesh: Mesh, body, rows, replicated=(), gen=None):
    """``body(*row shards, *replicated, [generator])`` for every shard in
    turn, under the shard's device; returns the per-shard results in
    shard order (a failing shard's exception propagates).  ``rows``:
    tensors (or tuples of tensors) whose leading axis is split into
    ``mesh.size`` contiguous blocks; ``replicated``: trees copied
    whole."""
    for a in _leaves(rows):
        if a.dim() == 0 or a.shape[0] % mesh.size:
            raise ValueError(f"an array of shape {tuple(a.shape)} does not "
                             f"split over a mesh of {mesh.size} shards")
    seeds = shard_seeds(gen, mesh) if gen is not None else None
    out = []
    for i, dev in enumerate(mesh.devices):
        with _on_device(dev):
            args = [_map_tree(lambda a: _split(a, mesh, i), r) for r in rows]
            args += [_map_tree(lambda a: a.to(dev), r) for r in replicated]
            if seeds is not None:
                args.append(_generator(seeds[i], dev))
            out.append(body(*args))
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def _gather(mesh: Mesh, outs, dim=0):
    """Concatenate per-shard results (tensors or tuples of them) on the
    mesh's first device."""
    first = mesh.devices[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(first) for o in outs], dim)
    return tuple(_gather(mesh, list(parts), dim) for parts in zip(*outs))


def lml_rows_sharded(types, params, log_noise, x, y, mask, *, mesh):
    """Row-sharded batched masked LML: each shard's rows through the full
    single-card dispatch (``gp_lml_batched``).  Bitwise the unsharded call
    on the same rows where the core computes each row alone (K1/K2, the
    plain versions, K4 -> K3 -> K5)."""
    outs = _on_shards(
        mesh, lambda t, p, ln, xb, yb, mb: gp_lml_batched(
            t, p, ln, xb, yb, mb, DEFAULT_JITTER),
        (types, params, log_noise, x, y, mask))
    return _gather(mesh, outs)


def structure_move_sharded(
    types_old, types_prop, params_old, params_prop,
    pri_old, pri_prop, log_hastings, log_noise, lml_old,
    x, y, mask, gen, eps_scale, *,
    mesh, n_hmc, n_leapfrog, step_size, step_jitter,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
):
    """The host engine's move (proposal LML -> MH accept -> select ->
    ``n_hmc`` HMC trajectories) over a mesh, one body a shard.  Returns
    per-row (accept, types, params, log_noise, lml, hmc accept rate,
    eps_scale)."""
    def body(to, tp, po, pp, prio, prip, lh, ln, lml0, xb, yb, mb, es, g):
        return _structure_move_body(
            to, tp, po, pp, prio, prip, lh, ln, lml0, xb, yb, mb, g, es,
            n_hmc=n_hmc, n_leapfrog=n_leapfrog, step_size=step_size,
            step_jitter=step_jitter, jitter=jitter, noise_mu=noise_mu,
            noise_sigma=noise_sigma, infer_noise=infer_noise)

    outs = _on_shards(mesh, body, (
        types_old, types_prop, params_old, params_prop, tuple(pri_old),
        tuple(pri_prop), log_hastings, log_noise, lml_old, x, y, mask,
        eps_scale), gen=gen)
    return _gather(mesh, outs)


def run_hmc_sharded(
    types, params, log_noise, prior_mu, prior_sigma, prior_active,
    x, y, mask, gen, eps_scale, *,
    mesh, n_steps, n_leapfrog, step_size, step_jitter,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
):
    """Row-sharded batched HMC (the panel's HMC-only rejuvenation): one
    ``run_hmc`` a shard.  Returns (params, log_noise, lml, rate_rows,
    eps_scale), all row-shaped."""
    def body(t, p, ln, mu, sg, act, xb, yb, mb, es, g):
        p2, ln2, lml, rate, es2, _ = run_hmc(
            t, p, ln, mu, sg, act, xb, yb, mb, g, n_steps=n_steps,
            n_leapfrog=n_leapfrog, step_size=step_size,
            step_jitter=step_jitter, jitter=jitter, noise_mu=noise_mu,
            noise_sigma=noise_sigma, infer_noise=infer_noise, eps_scale=es)
        return p2, ln2, lml, rate, es2

    outs = _on_shards(mesh, body, (
        types, params, log_noise, prior_mu, prior_sigma, prior_active, x, y,
        mask, eps_scale), gen=gen)
    return _gather(mesh, outs)


def rejuvenation_sweep_sharded(
    types, params, log_noise, lml, x, y, mask, gen, eps_scale, cfg, anc, *,
    mesh, n_mcmc, n_hmc, n_leapfrog, step_size, step_jitter,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
):
    """``inference.device_smc.rejuvenation_sweep`` over a mesh: the
    device-proposal moves of the panel fit and the nowcast refresh, one
    sweep a shard.  ``cfg``/``anc`` (the structure-prior tables) are
    replicated.  Returns (types, params, log_noise, lml, accept_rate_rows,
    eps_scale), the accept rate of each shard broadcast to its rows."""
    def body(t, p, ln, l0, xb, yb, mb, es, cfg_b, anc_b, g):
        t2, p2, ln2, l2, rate, es2 = rejuvenation_sweep(
            t, p, ln, l0, xb, yb, mb, g, cfg_b, anc_b, n_mcmc=n_mcmc,
            n_hmc=n_hmc, n_leapfrog=n_leapfrog, step_size=step_size,
            step_jitter=step_jitter, jitter=jitter, noise_mu=noise_mu,
            noise_sigma=noise_sigma, infer_noise=infer_noise, eps_scale=es)
        return t2, p2, ln2, l2, rate.expand(l2.shape).clone(), es2

    outs = _on_shards(mesh, body, (
        types, params, log_noise, lml, x, y, mask, eps_scale),
        replicated=(cfg, anc), gen=gen)
    return _gather(mesh, outs)


def forecast_hmc_scan_sharded(
    types, params, log_noise, prior_mu, prior_sigma, prior_active,
    x, y, mask, xs, log_w, gen, eps_scale, *,
    mesh, n_scenarios, n_draws, n_hmc, n_leapfrog, step_size, step_jitter,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
):
    """``ops.forecast_scan.nowcast_forecast_hmc_scan`` with the scenarios
    sharded: each shard runs the whole scan for its ``n_scenarios / size``
    contiguous scenarios, so the (m, S * D) samples' columns concatenate
    in the unsharded call's order.  ``xs`` is replicated; ``log_w`` (S, P)
    is split on its scenario axis."""
    if n_scenarios % mesh.size:
        raise ValueError(f"{n_scenarios} scenarios do not split over a mesh "
                         f"of {mesh.size} shards")
    s_loc = n_scenarios // mesh.size

    def body(t, p, ln, mu, sg, act, xb, yb, mb, es, lw, xs_b, g):
        return nowcast_forecast_hmc_scan(
            t, p, ln, mu, sg, act, xb, yb, mb, xs_b, lw, g, es,
            n_scenarios=s_loc, n_draws=n_draws, n_hmc=n_hmc,
            n_leapfrog=n_leapfrog, step_size=step_size,
            step_jitter=step_jitter, jitter=jitter, noise_mu=noise_mu,
            noise_sigma=noise_sigma, infer_noise=infer_noise)

    outs = _on_shards(mesh, body, (
        types, params, log_noise, prior_mu, prior_sigma, prior_active, x, y,
        mask, eps_scale, log_w), replicated=(xs,), gen=gen)
    samples = _gather(mesh, [o[0] for o in outs], dim=1)
    rest = _gather(mesh, [o[1:] for o in outs])
    return (samples, *rest)


def panel_smc_step(
    types_old, types_prop, params, params_prop,
    pri_old, pri_prop, log_hastings, log_noise, log_weight, lml_cached,
    eps_scale, x, y, mask_new, gen, *,
    n_hmc, n_leapfrog, step_size=0.02, step_jitter=0.5,
    jitter=DEFAULT_JITTER, noise_mu=-2.0, noise_sigma=1.0, infer_noise=1.0,
):
    """One full SMC training step over a flattened (series x particle) row
    axis, on one device: (1) reweight to ``mask_new`` (a particle broken on
    either side of the reweight loses its weight), (2) one structure move
    (MH accept of host-proposed trees), (3) ``n_hmc`` HMC trajectories.
    Returns (types, params, log_noise, log_weight, lml, accept, hmc accept
    rate (R,), eps_scale)."""
    R = params.shape[0]
    with torch.no_grad():
        lml_new = gp_lml_batched(types_old, params, log_noise, x, y,
                                 mask_new, jitter)
        broken = (lml_cached <= -1e9) | (lml_new <= -1e9)
        log_weight = log_weight + torch.where(
            broken, torch.full_like(lml_new, -1e10), lml_new - lml_cached)
        lml_prop = gp_lml_batched(types_prop, params_prop, log_noise, x, y,
                                  mask_new, jitter)
    logit = lml_prop - lml_new + log_hastings
    u = torch.rand(R, generator=gen, device=params.device)
    accept = torch.log(u) < logit
    a1, a3 = accept[:, None], accept[:, None, None]
    types = torch.where(a1, types_prop, types_old)
    params = torch.where(a3, params_prop, params)
    mu, sg, act = (torch.where(a3, new, old)
                   for new, old in zip(pri_prop, pri_old))
    lml = torch.where(accept, lml_prop, lml_new)
    params, log_noise, lml, rate, eps_scale, _ = run_hmc(
        types, params, log_noise, mu, sg, act, x, y, mask_new, gen,
        n_steps=n_hmc, n_leapfrog=n_leapfrog, step_size=step_size,
        step_jitter=step_jitter, jitter=jitter, noise_mu=noise_mu,
        noise_sigma=noise_sigma, infer_noise=infer_noise,
        eps_scale=eps_scale)
    return (types, params, log_noise, log_weight, lml, accept, rate,
            eps_scale)
