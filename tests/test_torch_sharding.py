"""Port parity: the mesh (``parallel/sharding.py``) and every ``mesh=``.

Within the port, on a CPU mesh of 4 shards (one device named 4 times, or
two CPU device indices named twice: two "cards"): ``lml_rows_sharded`` is
bitwise ``gp_lml_batched`` on the same rows, and
``run_hmc_sharded``, ``rejuvenation_sweep_sharded``,
``structure_move_sharded`` and ``forecast_hmc_scan_sharded`` are bitwise
their per-shard emulation: the single-card body on each shard's rows with
that shard's generator (``shard_seeds``), concatenated -- the JAX
package's own test pattern (``tests/test_parallel.py``).

Against the JAX package: ``lml_rows_sharded`` on its 8-device CPU mesh
(``tests/conftest.py``), to the LML tolerance of ``test_torch_lml.py``;
and a moveless ``fit_panel(mesh=)`` of 3 series x 2 particles on a mesh
of 4, which pads the series to 4, resamples and trims as JAX's does:
resample indices, trees and parameters bitwise (one numpy stream in
both), weights and LMLs to float32 tolerance.

The launch counters are exact when several host threads launch at once:
a test forces the interpreter to switch threads between the bytecodes of
every bump, which loses counts from any unsynchronised
read-modify-write.
"""

import datetime as dt
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nowcastautogp_tpu as jngp
import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.parallel import panel as jpanel
from nowcastautogp_tpu.parallel import sharding as jsharding
from nowcastautogp_tpu_torch.inference.device_smc import rejuvenation_sweep
from nowcastautogp_tpu_torch.inference.hmc import run_hmc
from nowcastautogp_tpu_torch.inference.structure_mcmc import (
    _structure_move_body, propose_batch,
)
from nowcastautogp_tpu_torch.models.config import GPConfig
from nowcastautogp_tpu_torch.models.structures import (
    prior_arrays, sample_particle,
)
from nowcastautogp_tpu_torch.models.structures_device import (
    ancestor_table, config_arrays,
)
from nowcastautogp_tpu_torch.ops import cudalib, lml, megalml
from nowcastautogp_tpu_torch.ops.forecast_scan import (
    nowcast_forecast_hmc_scan,
)
from nowcastautogp_tpu_torch.parallel import panel, sharding
from nowcastautogp_tpu_torch.parallel.sharding import Mesh

torch.set_num_threads(1)

MESH = Mesh(["cpu"] * 4)
# two "cards" (CPU device indices), two shards each
TWO_CARDS = Mesh(["cpu:0", "cpu:1"] * 2)
R, CAP = 8, 32
HMC = dict(n_leapfrog=2, step_size=0.02, step_jitter=0.5)
VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
LW_RTOL, LW_ATOL = 1e-5, 1e-4


def _rows(seed, n_active=28, rows=R):
    """Depth-3 particles with distinct per-row data buffers (numpy)."""
    cfg = GPConfig(max_depth=3)
    rng = np.random.default_rng(seed)
    ts, ps, lns = zip(*(sample_particle(rng, cfg) for _ in range(rows)))
    x = np.broadcast_to(np.linspace(0, 1, CAP), (rows, CAP)).astype(
        np.float32) + rng.uniform(0, 0.01, (rows, 1)).astype(np.float32)
    y = rng.normal(0.0, 1.0, (rows, CAP)).astype(np.float32)
    mask = np.broadcast_to((np.arange(CAP) < n_active).astype(np.float32),
                           (rows, CAP)).copy()
    return (cfg, rng, np.stack(ts).astype(np.int32),
            np.stack(ps).astype(np.float32), np.asarray(lns, np.float32),
            x, y, mask)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _emulate(body, rows, seed, replicated=(), mesh=MESH):
    """The per-shard emulation: ``body`` on each shard's rows with the
    shard's generator (from a generator seeded ``seed``), concatenated."""
    seeds = sharding.shard_seeds(torch.Generator().manual_seed(seed), mesh)
    k = rows[0].shape[0] // mesh.size
    outs = []
    for i, s in enumerate(seeds):
        sl = slice(i * k, (i + 1) * k)
        shard = [tuple(t[sl] for t in r) if isinstance(r, tuple) else r[sl]
                 for r in rows]
        outs.append(body(*shard, *replicated,
                         torch.Generator().manual_seed(s)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _assert_bitwise(got, want, names):
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        assert torch.equal(g, w), name


# ------------------------------------------------------------ counters


def test_launch_counts_are_exact_under_threads():
    """Eight threads (more than this box's cores) bump K1's counter while
    a trace hook hands the interpreter lock to another thread between
    every two bytecodes of a bump: an unsynchronised ``+=`` loses counts
    there; the counter must not."""
    n_threads, n_bumps = 8, 100
    code = cudalib.LaunchCounter.bump.__code__

    def tracer(frame, event, arg):
        if frame.f_code is code:
            frame.f_trace_opcodes = True
            return yield_lock
        return None

    def yield_lock(frame, event, arg):
        if event == "opcode":
            time.sleep(0)
        return yield_lock

    def worker():
        for _ in range(n_bumps):
            megalml._LAUNCHES.bump("K1_LAUNCHES")

    megalml.reset_launch_counts()
    interval = sys.getswitchinterval()
    threading.settrace(tracer)
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        threading.settrace(None)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert megalml.K1_LAUNCHES == n_threads * n_bumps
    assert megalml.K2_LAUNCHES == 0
    megalml.reset_launch_counts()
    assert megalml.K1_LAUNCHES == 0


# ------------------------------------------------------ mesh, in the port


def test_mesh_and_shard_rows():
    mesh = Mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.axis_name == "series"
    assert mesh.device_share() == 1.0
    a, b = torch.arange(6.0).reshape(6, 1), torch.arange(4.0)
    shards = sharding.shard_rows((a, (b, 7)), mesh)
    assert len(shards) == 3
    for i, (sa, (sb, seven)) in enumerate(shards):
        assert torch.equal(sa, a[2 * i:2 * i + 2])   # 6 rows divide: split
        assert torch.equal(sb, b) and seven == 7      # 4 do not: replicated
    with pytest.raises(ValueError):
        Mesh([])


def test_make_mesh_takes_the_cards():
    if torch.cuda.is_available():
        mesh = ngp.make_mesh()
        assert mesh.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ngp.make_mesh()


@pytest.mark.parametrize("mesh", [MESH, TWO_CARDS], ids=["one", "two"])
def test_lml_rows_sharded_is_bitwise_unsharded(mesh):
    _, _, types, params, log_noise, x, y, mask = _rows(1)
    args = _t(types, params, log_noise, x, y, mask)
    got = sharding.lml_rows_sharded(*args, mesh=mesh)
    assert torch.equal(got, lml.gp_lml_batched(*args))
    with pytest.raises(ValueError, match="does not split"):
        sharding.lml_rows_sharded(*(a[:6] for a in args), mesh=MESH)


@pytest.mark.parametrize("mesh", [MESH, TWO_CARDS], ids=["one", "two"])
def test_run_hmc_sharded_is_its_per_shard_emulation(mesh):
    cfg, _, types, params, log_noise, x, y, mask = _rows(2)
    rows = _t(types, params, log_noise, *prior_arrays(types, cfg), x, y,
              mask) + [torch.ones(R)]

    def body(t, p, ln, mu, sg, act, xb, yb, mb, es, g):
        return run_hmc(t, p, ln, mu, sg, act, xb, yb, mb, g, n_steps=2,
                       eps_scale=es, jitter=1e-5, **HMC)[:5]

    got = sharding.run_hmc_sharded(
        *rows[:9], torch.Generator().manual_seed(3), rows[9], mesh=mesh,
        n_steps=2, **HMC)
    _assert_bitwise(got, _emulate(body, rows, 3, mesh=mesh),
                    ["params", "log_noise", "lml", "rate_rows", "eps_scale"])


def test_rejuvenation_sweep_sharded_is_its_per_shard_emulation():
    cfg, _, types, params, log_noise, x, y, mask = _rows(4)
    tables = (config_arrays(cfg, "cpu"),
              torch.as_tensor(ancestor_table(cfg.max_nodes)))
    rows = _t(types, params, log_noise) + [torch.zeros(R)] + _t(x, y, mask) \
        + [torch.ones(R)]
    kw = dict(n_mcmc=2, n_hmc=1, **HMC)

    def body(t, p, ln, l0, xb, yb, mb, es, cfg_a, anc, g):
        out = rejuvenation_sweep(t, p, ln, l0, xb, yb, mb, g, cfg_a, anc,
                                 eps_scale=es, **kw)
        return (*out[:4], out[4].expand(t.shape[0]), out[5])

    got = sharding.rejuvenation_sweep_sharded(
        *rows[:7], torch.Generator().manual_seed(5), rows[7], *tables,
        mesh=MESH, **kw)
    _assert_bitwise(got, _emulate(body, rows, 5, tables),
                    ["types", "params", "log_noise", "lml", "rate",
                     "eps_scale"])


def test_structure_move_sharded_is_its_per_shard_emulation():
    cfg, rng, types, params, log_noise, x, y, mask = _rows(6)
    tp, pp, log_h, pri_prop = propose_batch(rng, types, params, cfg)
    rows = (_t(types, tp, params, pp)
            + [tuple(_t(*prior_arrays(types, cfg))), tuple(_t(*pri_prop))]
            + _t(log_h, log_noise) + [torch.zeros(R)] + _t(x, y, mask))
    kw = dict(n_hmc=1, jitter=1e-5, noise_mu=-2.0, noise_sigma=1.0,
              infer_noise=1.0, **HMC)

    def body(to, tp_, po, pp_, pri_o, pri_p, lh, ln, l0, xb, yb, mb, es, g):
        return _structure_move_body(to, tp_, po, pp_, pri_o, pri_p, lh, ln,
                                    l0, xb, yb, mb, g, es, **kw)

    got = sharding.structure_move_sharded(
        *rows, torch.Generator().manual_seed(7), torch.ones(R), mesh=MESH,
        **kw)
    _assert_bitwise(got, _emulate(body, rows + [torch.ones(R)], 7),
                    ["accept", "types", "params", "log_noise", "lml",
                     "rate_rows", "eps_scale"])


def test_forecast_hmc_scan_sharded_is_its_per_shard_emulation():
    """4 scenarios x 2 particles: each shard scans one scenario; the
    samples' columns concatenate in scenario order."""
    cfg, rng, types, params, log_noise, x, y, mask = _rows(8)
    S, P, D = 4, 2, 3
    xs = torch.linspace(1.0, 1.1, 3)
    log_w = torch.as_tensor(rng.normal(0, 1, (S, P)).astype(np.float32))
    rows = _t(types, params, log_noise, *prior_arrays(types, cfg), x, y,
              mask) + [torch.ones(R)]
    kw = dict(n_draws=D, n_hmc=1, **HMC)

    def body(t, p, ln, mu, sg, act, xb, yb, mb, es, lw, xs_b, g):
        return nowcast_forecast_hmc_scan(t, p, ln, mu, sg, act, xb, yb, mb,
                                         xs_b, lw, g, es, n_scenarios=1,
                                         **kw)

    got = sharding.forecast_hmc_scan_sharded(
        *rows[:9], xs, log_w, torch.Generator().manual_seed(9), rows[9],
        mesh=MESH, n_scenarios=S, **kw)
    seeds = sharding.shard_seeds(torch.Generator().manual_seed(9), MESH)
    parts = [body(*(r[2 * i:2 * i + 2] for r in rows), log_w[i:i + 1], xs,
                  torch.Generator().manual_seed(s))
             for i, s in enumerate(seeds)]
    assert got[0].shape == (3, S * D)
    assert torch.equal(got[0], torch.cat([p[0] for p in parts], 1))
    for j in range(1, 4):
        assert torch.equal(got[j], torch.cat([p[j] for p in parts]))


def _nowcast_model():
    n = 26
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    y = 6.5 + 0.6 * np.sin(np.arange(n) / 4.0)
    data = ngp.create_transformed_data(dates, y)
    model = ngp.make_and_fit_model(data, n_particles=2, n_mcmc=0, n_hmc=1,
                                   seed=1, config=ngp.GPConfig(max_depth=3),
                                   device="cpu")
    nc_dates = [dates[-1] + dt.timedelta(weeks=i + 1) for i in range(2)]
    ncs = ngp.create_nowcast_data(
        [np.array([6.4, 6.6]) + 0.01 * i for i in range(5)], nc_dates)
    f_dates = [nc_dates[-1] + dt.timedelta(weeks=i + 1) for i in range(2)]
    return model, ncs, f_dates


@pytest.mark.parametrize("refresh", [dict(n_hmc=1), dict(forecast_n_hmc=1)])
def test_forecast_with_nowcasts_pads_scenarios_to_the_mesh(refresh,
                                                          monkeypatch):
    """S = 5 scenarios on a mesh of 4: one chunk of 8 (the last scenario
    repeated), its reweight LMLs and refresh through the sharded wrappers,
    the padded columns trimmed; the base model is unchanged."""
    model, ncs, f_dates = _nowcast_model()
    from nowcastautogp_tpu_torch import nowcast

    calls = []
    for name in ("lml_rows_sharded", "run_hmc_sharded",
                 "forecast_hmc_scan_sharded"):
        real = getattr(nowcast, name)
        monkeypatch.setattr(nowcast, name, lambda *a, _r=real, _n=name, **k:
                            calls.append((_n, k["mesh"].size,
                                          a[0].shape[0])) or _r(*a, **k))
    before = model.to_dict()["params"].copy()
    fc = ngp.forecast_with_nowcasts(model, ncs, f_dates, 3, mesh=MESH,
                                    **refresh)
    assert fc.shape == (2, 5 * 3) and np.all(np.isfinite(fc))
    assert calls[:2] == [("lml_rows_sharded", 4, 16)] * 2
    second = ("run_hmc_sharded" if "n_hmc" in refresh
              else "forecast_hmc_scan_sharded")
    assert calls[2:] == [(second, 4, 16)]
    np.testing.assert_array_equal(model.to_dict()["params"], before)


def test_nowcast_scenario_chunk_budgets_a_device(monkeypatch):
    """With a budget of 4 scenarios a device: 4 without a mesh, 4 on a
    mesh of 4 shards on one device, 8 (all 5, padded) when the 4 shards
    sit on two devices."""
    model, ncs, _ = _nowcast_model()
    from nowcastautogp_tpu_torch import nowcast

    cap = nowcast._scenario_cap(model, ncs[0].ds)
    monkeypatch.setattr(nowcast, "_CHUNK_BYTES", 4 * model.num_particles
                        * nowcast._ROW_MATRICES * cap * cap * 4)
    two_cards = Mesh(["cpu:0", "cpu:1"] * 2)
    assert two_cards.device_share() == 0.5
    assert [nowcast._scenario_chunk(model, ncs, m)
            for m in (None, MESH, two_cards)] == [4, 4, 8]


# --------------------------------------------------- mesh, against JAX


@pytest.fixture(scope="module")
def jax_lml_rows():
    _, _, types, params, log_noise, x, y, mask = _rows(10, rows=16)
    got = jsharding.lml_rows_sharded(
        jnp.asarray(types), jnp.asarray(params), jnp.asarray(log_noise),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        mesh=jsharding.make_mesh(8))
    return (types, params, log_noise, x, y, mask), np.asarray(got)


def test_lml_rows_sharded_matches_jax(jax_lml_rows):
    args, want = jax_lml_rows
    got = sharding.lml_rows_sharded(*_t(*args), mesh=Mesh(["cpu"] * 8))
    np.testing.assert_allclose(got.numpy(), want, rtol=VAL_RTOL,
                               atol=VAL_ATOL)


# two particles resample only when the ESS gate is above one particle
LENS, P, SEED, ESS_FRACTION = (24, 30, 27), 2, 3, 1.0


def _datasets(pkg):
    out = []
    for s, n in enumerate(LENS):
        dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i)
                 for i in range(n)]
        t = np.arange(n)
        rng = np.random.default_rng(s)
        y = 6.5 + 0.6 * np.sin(2 * np.pi * t / 26 + s) \
            + 0.12 * rng.standard_normal(n)
        out.append(pkg.create_transformed_data(dates, y))
    return out


def _recording(module, calls):
    inner = module.resample_indices

    def recording(rng, log_w, *args):
        out = inner(rng, log_w, *args)
        calls.append(np.asarray(out))
        return out
    return recording


@pytest.fixture(scope="module")
def jax_mesh_panel():
    calls = []
    saved = jpanel.resample_indices
    jpanel.resample_indices = _recording(jpanel, calls)
    try:
        models = jngp.fit_panel(_datasets(jngp), n_particles=P, n_mcmc=0,
                                n_hmc=0, seed=SEED, engine="host",
                                ess_fraction=ESS_FRACTION,
                                config=jngp.GPConfig(max_depth=3),
                                mesh=jsharding.make_mesh(4))
    finally:
        jpanel.resample_indices = saved
    return [m.to_dict() for m in models], calls


def test_moveless_mesh_panel_matches_jax(jax_mesh_panel, monkeypatch):
    """3 series x 2 particles do not divide a mesh of 4: both packages pad
    to 4 series (8 rows), drawing the padded series' numbers from the one
    stream, resample each series whose ESS falls below 2, and trim the
    padded series from the result."""
    jstates, jcalls = jax_mesh_panel
    calls, sharded = [], []
    monkeypatch.setattr(panel, "resample_indices", _recording(panel, calls))
    real = panel.lml_rows_sharded
    monkeypatch.setattr(panel, "lml_rows_sharded", lambda *a, **k: (
        sharded.append(a[0].shape[0]) or real(*a, **k)))
    models = ngp.fit_panel(_datasets(ngp), n_particles=P, n_mcmc=0, n_hmc=0,
                           seed=SEED, engine="host", ess_fraction=ESS_FRACTION,
                           config=ngp.GPConfig(max_depth=3), mesh=MESH)
    assert sharded and set(sharded) == {8}
    assert jcalls and len(calls) == len(jcalls)
    for got, want in zip(calls, jcalls):
        np.testing.assert_array_equal(got, want)
    assert len(models) == len(jstates) == len(LENS)
    for model, js in zip(models, jstates):
        d = model.to_dict()
        for key in ("y", "order", "node_types", "params", "log_noise",
                    "hmc_eps_scale"):
            np.testing.assert_array_equal(d[key], js[key], err_msg=key)
        for key in ("log_weight", "lml"):
            np.testing.assert_allclose(d[key], js[key], rtol=LW_RTOL,
                                       atol=LW_ATOL, err_msg=key)


def test_panel_smc_step_matches_jax_without_moves():
    """``panel_smc_step`` with every proposal rejected and no HMC: the
    reweight (sentinel guard included) and the carried state are
    deterministic, so they match JAX's step."""
    cfg, _, types, params, log_noise, x, y, mask = _rows(12)
    pri = prior_arrays(types, cfg)
    log_w = np.zeros(R, np.float32)
    lml_cached = np.full(R, -3.0, np.float32)
    lml_cached[1] = -2e9                                # a broken particle
    log_h = np.full(R, -1e30, np.float32)               # reject every move
    args = (types, types, params, params, pri, pri, log_h, log_noise, log_w,
            lml_cached, np.ones(R, np.float32), x, y, mask)
    want = jsharding.panel_smc_step(
        *(tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
          else jnp.asarray(a) for a in args), jax.random.PRNGKey(0),
        n_hmc=0, n_leapfrog=2)
    got = sharding.panel_smc_step(
        *(tuple(_t(*a)) if isinstance(a, tuple) else torch.as_tensor(a)
          for a in args), torch.Generator().manual_seed(0), n_hmc=0,
        n_leapfrog=2)
    names = ["types", "params", "log_noise", "log_weight", "lml", "accept"]
    for name, g, w in zip(names, got, want):
        if name in ("log_weight", "lml"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=VAL_RTOL, atol=VAL_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert got[3][1] == -1e10
