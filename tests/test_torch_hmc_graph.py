"""``run_hmc``'s captured trajectories against its eager loop, on a card.

Skipped where torch sees no CUDA device (the CPU test run); on a machine
with a card run ``python -m pytest --noconftest tests/test_torch_hmc_graph.py
-q``.  The replayed graphs run the same kernels on the same numbers in the
same order as the eager loop, from the same generator, so every output
must equal the eager one bit for bit: at P = 200 and 31 heap slots, at
capacities 32 and 160 (K1), with and without a carried initial evaluation,
and at capacity 576 (the composed core K4 -> K3 -> K5).  The launch
counters, which a replay does not bump by itself, must read as they do
eagerly, and a call's returned tensors must survive the next call.
"""

import collections
import datetime as dt

import numpy as np
import pytest
import torch

import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu_torch.inference import hmc
from nowcastautogp_tpu_torch.models.gp_model import GPModel
from nowcastautogp_tpu_torch.models.structures import prior_arrays
from nowcastautogp_tpu_torch.ops import megalml
from nowcastautogp_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

HMC_KW = dict(n_leapfrog=5, step_size=0.1, step_jitter=0.5, jitter=1e-5)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty graph cache, so each test sees its own captures."""
    monkeypatch.setattr(hmc, "_GRAPHS", collections.OrderedDict())


def _eager(monkeypatch):
    monkeypatch.setattr(hmc, "_uses_graph", lambda *a: False)


def _problem(dev, n_obs, P, n, seed=0):
    """Prior-sampled depth-5 particles (31 heap slots) on a weekly series
    of ``n_obs`` points: the positional arguments of ``run_hmc`` before
    the generator, conditioned on the first ``n`` points at their
    capacity."""
    dates = [dt.date(2020, 1, 6) + dt.timedelta(weeks=i) for i in range(n_obs)]
    t = np.arange(n_obs)
    rng = np.random.default_rng(seed)
    y = np.log(900 * np.exp(0.7 * np.sin(2 * np.pi * t / 52)
                            + 0.15 * rng.standard_normal(n_obs)))
    pm = GPModel(dates, y, n_particles=P, seed=seed + 1, device=dev,
                 config=ngp.GPConfig(max_depth=5))
    assert pm._types_d().shape == (P, 31)
    x, yb, m = pm._batched_data(n, bucket=True)
    mu, sg, act = (pm._tensor(a) for a in
                   prior_arrays(pm._host_types, pm.config))
    noise_mu, noise_sigma, infer = pm.noise_prior
    kw = dict(HMC_KW, noise_mu=noise_mu, noise_sigma=noise_sigma,
              infer_noise=infer,
              eps_scale=torch.linspace(0.3, 3.0, P, device=dev))
    return (pm._types_d(), pm._params_d, pm._log_noise_d, mu, sg, act, x, yb,
            m), kw


def _init(args, kw):
    pot = hmc.make_batched_potential(
        *args[:1], *args[3:], kw["jitter"], kw["noise_mu"],
        kw["noise_sigma"], kw["infer_noise"])
    return hmc._value_and_grad(pot, args[1], args[2])


def _flat(out):
    p, ln, lml, rate, scale, (U, g_p, g_n) = out
    return [p, ln, lml, rate, scale, U, g_p, g_n]


def _assert_bitwise(want, got):
    for i, (w, g) in enumerate(zip(_flat(want), _flat(got))):
        assert w.shape == g.shape and w.dtype == g.dtype, i
        assert torch.equal(w.view(torch.int32), g.view(torch.int32)), i


def _two_calls(args, kw, seed, init):
    """``run_hmc`` with one trajectory (a warm-up job's), then five from
    where it ended (a timed job's); both outputs, the counts and the
    generator's final state."""
    gen = torch.Generator(device=args[1].device).manual_seed(seed)
    kw = dict(kw, init=_init(args, kw) if init else None)
    with profiling.recording() as rec:
        first = hmc.run_hmc(*args, gen, n_steps=1, **kw)
        p, ln, _, _, scale, carried = first
        kw.update(eps_scale=scale,
                  init=(carried[0], first[2]) + carried[1:] if init else None)
        second = hmc.run_hmc(args[0], p, ln, *args[3:], gen, n_steps=5, **kw)
    torch.cuda.synchronize()
    return first, second, dict(rec.counts), gen.get_state()


@pytest.mark.parametrize("given_init", [False, True])
@pytest.mark.parametrize("n, cap", [(30, 32), (150, 160)])
def test_graph_equals_eager(dev, monkeypatch, fresh_cache, n, cap,
                            given_init):
    args, kw = _problem(dev, 150, 200, n)
    assert args[6].shape == (200, cap)
    graphed = _two_calls(args, kw, 7, given_init)
    _eager(monkeypatch)
    eager = _two_calls(args, kw, 7, given_init)
    _assert_bitwise(eager[0], graphed[0])
    _assert_bitwise(eager[1], graphed[1])
    assert torch.equal(eager[3], graphed[3])
    # the one-trajectory call captured what the five-trajectory call replays
    assert graphed[2] == {"hmc/graph_captures": 1 if given_init else 2,
                          "hmc/graph_replays": 6}
    assert eager[2] == {"hmc/eager_trajectories": 6}


def test_composed_core_graph_equals_eager(dev, monkeypatch, fresh_cache):
    args, kw = _problem(dev, 560, 16, 560)
    assert args[6].shape == (16, 576)
    graphed = _two_calls(args, kw, 3, False)
    _eager(monkeypatch)
    eager = _two_calls(args, kw, 3, False)
    _assert_bitwise(eager[0], graphed[0])
    _assert_bitwise(eager[1], graphed[1])
    assert graphed[2]["hmc/graph_replays"] == 6


def test_outputs_survive_the_next_call(dev, fresh_cache):
    """A replay writes only the graphs' own buffers: the first call's
    returned tensors read the same after a second call at the same key,
    and share no storage with its outputs or the arguments."""
    args, kw = _problem(dev, 150, 200, 150)
    gen = torch.Generator(device=dev).manual_seed(5)
    first = _flat(hmc.run_hmc(*args, gen, n_steps=2, **kw))
    kept = [t.clone() for t in first]
    second = _flat(hmc.run_hmc(args[0], first[0], first[1], *args[3:], gen,
                               n_steps=3, **dict(kw, eps_scale=first[4])))
    torch.cuda.synchronize()
    for k, t in zip(kept, first):
        assert torch.equal(k.view(torch.int32), t.view(torch.int32))
    theirs = {t.data_ptr() for t in second + list(args) + [kw["eps_scale"]]}
    assert not theirs & {t.data_ptr() for t in first}
    assert not torch.equal(second[0], first[0])   # the second call moved


def test_launch_counts_match_eager(dev, monkeypatch, fresh_cache):
    """A replay bumps the launch counters by what its capture launched, and
    the capture itself (and the eager run before it) counts nothing: K1
    once a gradient, 1 + 5 x 5 a call, as the eager loop counts."""
    args, kw = _problem(dev, 150, 200, 150)

    def counts():
        return (megalml.K1_LAUNCHES, megalml.K2_LAUNCHES,
                megalml.K1_BWD_LAUNCHES)

    def launches():
        gen = torch.Generator(device=dev).manual_seed(9)
        out = []
        for _ in range(2):      # the first call captures, the second not
            before = counts()
            hmc.run_hmc(*args, gen, n_steps=5, **kw)
            out.append(tuple(a - b for a, b in zip(counts(), before)))
        return out

    graphed = launches()
    _eager(monkeypatch)
    eager = launches()
    assert graphed == eager
    assert eager[0][:2] == (26, 0)
