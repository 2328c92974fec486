"""The plain reference against the program's plain CPU path, at small
sizes: covariances, data rules, LML, predictive and scores."""

from __future__ import annotations

import datetime as dt

import numpy as np
import pytest
import torch

from benchmark.reference import data, gp, heap, scoring
from benchmark.series import ed_daily, nhsn_weekly


def _trees(P=12, depth=4, seed=0):
    from nowcastautogp_tpu_torch.models.config import GPConfig
    from nowcastautogp_tpu_torch.models.structures import sample_particle

    rng = np.random.default_rng(seed)
    cfg = GPConfig(max_depth=depth)
    out = [sample_particle(rng, cfg) for _ in range(P)]
    types = np.stack([o[0] for o in out])
    params = np.stack([o[1] for o in out]).astype(np.float64)
    noise = np.asarray([o[2] for o in out], dtype=np.float64)
    return (torch.as_tensor(types, dtype=torch.int64),
            torch.as_tensor(params), torch.as_tensor(noise))


def test_heap_matches_program_interpreter():
    from nowcastautogp_tpu_torch.ops.kernels import eval_cov_batch

    types, params, _ = _trees()
    x1 = torch.linspace(0, 1, 17, dtype=torch.float64)
    x2 = torch.linspace(-0.2, 1.3, 9, dtype=torch.float64)
    for a, b in ((x1, x1), (x1, x2)):
        want = eval_cov_batch(types, params, a, b)
        assert torch.equal(heap.cov(types, params, a, b), want)


@pytest.mark.parametrize("gen", [nhsn_weekly, ed_daily])
def test_data_rules_match_program(gen):
    import nowcastautogp_tpu_torch as ngp

    dates, obs = gen.generate(90, np.random.default_rng(3))
    fwd, _ = ngp.get_transformations("boxcox", obs)
    np.testing.assert_allclose(data.boxcox_forward(obs)(obs), fwd(obs),
                               rtol=0, atol=1e-12)
    model = ngp.GPModel(dates, fwd(obs), n_particles=2, seed=1, device="cpu")
    st = model.to_dict()
    norm = data.Normaliser(dates, fwd(obs))
    for key in ("t0", "t_scale", "y_mean", "y_std"):
        assert getattr(norm, key) == pytest.approx(st[key], rel=1e-15)
    assert data.capacity(len(obs)) == model._cap


def test_zero_offset_and_log_fallback():
    import nowcastautogp_tpu_torch as ngp

    obs = np.array([0.0, 3.0, 5.0, 2.0, 8.0, 1.0, 4.0])
    fwd, _ = ngp.get_transformations("boxcox", obs)
    np.testing.assert_allclose(data.boxcox_forward(obs)(obs), fwd(obs),
                               atol=1e-12)
    assert data.days([dt.date(1970, 1, 11)])[0] == 10.0


@pytest.mark.parametrize("n,prop", [(150, 0.1), (560, 0.125), (40, 0.5),
                                    (7, 0.01)])
def test_schedule_matches_program(n, prop):
    from nowcastautogp_tpu_torch.inference.schedule import linear_schedule
    from nowcastautogp_tpu_torch.inference.smc import schedule_segments

    want = linear_schedule(n, max(prop, 1.0 / n))
    assert data.linear_schedule(n, prop) == want
    assert data.schedule_segments(want, data.capacity(n)) == (
        schedule_segments(want, data.capacity(n)))


def test_lml_and_predictive_match_program():
    from nowcastautogp_tpu_torch.ops.lml import (
        gp_lml_batched, gp_predict_batch,
    )

    types, params, noise = _trees(P=6, depth=3, seed=4)
    x = torch.linspace(0, 1, 24, dtype=torch.float64)
    y = torch.sin(6 * x)
    xs = torch.linspace(1.02, 1.2, 5, dtype=torch.float64)
    out = gp.solve(types, params, noise, x, y[:, None], xs)
    m = torch.ones(6, 32, dtype=torch.float64)
    m[:, 24:] = 0
    xp = torch.cat([x, torch.zeros(8, dtype=torch.float64)])
    yp = torch.cat([y, torch.zeros(8, dtype=torch.float64)])
    want = gp_lml_batched(types, params, noise, xp, yp, m)
    ok = want > -1e9
    torch.testing.assert_close(out["lml"][ok, 0], want[ok], rtol=1e-9,
                               atol=1e-8)
    mu, cov = gp_predict_batch(types, params, noise, xp, yp, m, xs)
    torch.testing.assert_close(out["mu"][ok, 0], mu[ok], rtol=1e-7,
                               atol=1e-8)
    torch.testing.assert_close(out["var"][ok],
                               torch.diagonal(cov, dim1=-2, dim2=-1)[ok],
                               rtol=1e-7, atol=1e-8)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      -(1.0 + 3 * 2.0**-11), 3.0e-5], dtype=torch.float64)
    got = gp.round_tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9,
                                -(1.0 + 2.0**-9)]
    assert abs(got[5].item() / 3.0e-5 - 1) <= 2.0**-11


def test_mixture_cdf_of_one_component_is_normal_cdf():
    z = torch.tensor([[[0.0, 1.0]]], dtype=torch.float64)
    u = gp.mixture_cdf(z, torch.zeros(1, 1, dtype=torch.float64),
                       torch.zeros(1, 1, 2, dtype=torch.float64),
                       torch.ones(1, 1, 2, dtype=torch.float64))
    torch.testing.assert_close(u[0, 0], torch.special.ndtr(z[0, 0]))


def test_scores_match_program():
    from nowcastautogp_tpu_torch.eval.crps import crps_ensemble

    rng = np.random.default_rng(1)
    draws = rng.lognormal(size=(3, 50))
    truth = np.array([1.0, 2.0, 0.5])
    want = np.mean([crps_ensemble(np.log(draws[i]), np.log(truth[i]))
                    for i in range(3)])
    assert scoring.log_crps(draws, truth) == pytest.approx(want, rel=1e-12)
    u = np.linspace(0.005, 0.995, 100)
    assert scoring.ks_uniform(u) == pytest.approx(0.005, abs=1e-12)
    assert scoring.ks_uniform(np.full(10, 0.5)) == pytest.approx(0.5)
