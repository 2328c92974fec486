"""Port parity for the slice as a whole: model, SMC pieces, nowcast.

The JAX package's ``GPModel`` and the port's are built from the same series
and seed; the port also takes the JAX model's state through
``GPModel.from_jax_state``.  Deterministic pieces (reweight LMLs, the
shared-Cholesky nowcast's weights, means and covariances) are held to f32
tolerances; the nowcast draws, whose random streams differ (threefry vs
torch), are compared in distribution.  Every JAX LML call here has one
shape (8 rows, 7 heap slots, capacity 32), so it compiles once.
"""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _session_once import once_per_session

import nowcastautogp_tpu as jngp
import nowcastautogp_tpu_torch as ngp
from nowcastautogp_tpu.ops import lml as jlml
from nowcastautogp_tpu_torch import nowcast
from nowcastautogp_tpu_torch.inference import hmc
from nowcastautogp_tpu_torch.inference.hmc import run_hmc
from nowcastautogp_tpu_torch.models.gp_model import GPModel
from nowcastautogp_tpu_torch.models.structures import prior_arrays
from nowcastautogp_tpu_torch.ops.lml import (
    composed_chunk, lml_core, set_lml_backend,
)
from nowcastautogp_tpu_torch.utils import profiling

torch.set_num_threads(1)

P, N_TRAIN, HORIZON = 8, 24, 4
VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
PRED_RTOL, PRED_ATOL = 1e-3, 1e-4
# Monte Carlo bound on the draw comparison, in standard errors
MC_SIGMAS = 5.0


def _series(n=N_TRAIN + 2 + HORIZON, seed=0):
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    obs = 800 * np.exp(0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
                       + 0.12 * rng.standard_normal(n))
    return dates, np.log(obs)


def _models(seed=5):
    dates, y = _series()
    kw = dict(n_particles=P, seed=seed)
    jm = jngp.GPModel(dates[:N_TRAIN], y[:N_TRAIN],
                      config=jngp.GPConfig(max_depth=3), **kw)
    pm = GPModel(dates[:N_TRAIN], y[:N_TRAIN],
                 config=ngp.GPConfig(max_depth=3), device="cpu", **kw)
    return jm, pm


def _nowcasts(S, seed=1):
    dates, y = _series()
    rng = np.random.default_rng(seed)
    draws = y[N_TRAIN:N_TRAIN + 2] + rng.normal(0.0, 0.05, (S, 2))
    nc_dates = dates[N_TRAIN:N_TRAIN + 2]
    return (nc_dates, draws, dates[N_TRAIN + 2:N_TRAIN + 2 + HORIZON])


def _fitted_states():
    jm, _ = _models()
    start = GPModel.from_jax_state(jm.to_dict(), device="cpu")
    lml = []
    for n_k in (10, N_TRAIN):
        jm.reweight_to(n_k)
        lml.append(np.asarray(jm._lml_d))
    return jm.to_dict(), start.to_dict(), lml


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A JAX model after two reweights, and the port's copy of its state
    before them (the port then repeats the reweights itself); the states
    are built by one worker a session (``_session_once``)."""
    jstate, start, lml = once_per_session(tmp_path_factory, "slice_fitted",
                                          _fitted_states)
    return jngp.GPModel(jstate), GPModel(start), lml


def test_particles_match_jax():
    jm, pm = _models()
    np.testing.assert_array_equal(pm._host_types, jm._host_types)
    np.testing.assert_array_equal(pm._params_d.numpy(), np.asarray(jm._params_d))
    np.testing.assert_array_equal(pm._log_noise_d.numpy(),
                                  np.asarray(jm._log_noise_d))
    assert pm.rng.bit_generator.state == jm.rng.bit_generator.state
    np.testing.assert_array_equal(pm._x_d.numpy(), np.asarray(jm._x_d))
    np.testing.assert_array_equal(pm._y_d.numpy(), np.asarray(jm._y_d))


def test_from_jax_state_round_trips():
    jm, _ = _models(seed=9)
    d = jm.to_dict()
    pm = GPModel.from_jax_state(d, device="cpu")
    got = pm.to_dict()
    for key in ("y", "order", "node_types", "params", "log_noise", "lml",
                "log_weight", "hmc_eps_scale"):
        np.testing.assert_array_equal(got[key], np.asarray(d[key]), key)
    for key in ("n_ingested", "t0", "t_scale", "y_mean", "y_std",
                "rng_state"):
        assert got[key] == d[key], key
    assert got["config"].node_dist_leaf == list(d["config"].node_dist_leaf)
    assert got["config"].prior == d["config"].prior
    again = GPModel(got).to_dict()
    assert again["generator_state"].tobytes() == got["generator_state"].tobytes()
    assert pm.clone().structures() == pm.structures()


def test_reweight_to_matches_jax(fitted):
    jm, pm, lml = fitted
    for n_k, ref in zip((10, N_TRAIN), lml):
        pm.reweight_to(n_k)
        np.testing.assert_allclose(pm._lml_d.numpy(), ref, rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
    np.testing.assert_allclose(pm.log_weight, jm.log_weight, rtol=VAL_RTOL,
                               atol=2 * VAL_ATOL)


def test_add_data_and_maybe_resample_match_jax(fitted):
    """Conditioning on two new weeks reweights by the same LMLs, and a
    forced resample draws the same ancestors from the same numpy state."""
    jm0 = fitted[0]
    jm = jngp.GPModel(jm0.to_dict())
    pm = GPModel.from_jax_state(jm0.to_dict(), device="cpu")
    dates, y = _series()
    new = (dates[N_TRAIN:N_TRAIN + 2], y[N_TRAIN:N_TRAIN + 2])
    jngp.add_data(jm, *new)
    ngp.add_data(pm, *new)
    np.testing.assert_allclose(pm._lml_d.numpy(), np.asarray(jm._lml_d),
                               rtol=VAL_RTOL, atol=VAL_ATOL)
    np.testing.assert_allclose(pm.log_weight, jm.log_weight, rtol=VAL_RTOL,
                               atol=2 * VAL_ATOL)
    # align the weights exactly so the resample decision and indices
    # depend on the shared numpy state only
    pm.log_weight = jm.log_weight.copy()
    assert ngp.maybe_resample(pm, P + 1) is jngp.maybe_resample(jm, P + 1)
    np.testing.assert_array_equal(pm._host_types, jm._host_types)
    np.testing.assert_array_equal(pm._params_d.numpy(),
                                  np.asarray(jm._params_d))
    assert not ngp.maybe_resample(pm, 0.0)


def _jax_shared_chol(jm, nowcasts, f_dates):
    """The JAX side of the deterministic shared-Cholesky quantities, built
    from its public batched LML and predictive."""
    x_row, y_rows, mask_old, mask_new = nowcast._scenario_buffers(
        GPModel.from_jax_state(jm.to_dict(), device="cpu"), nowcasts)
    cap = x_row.shape[0]

    def rows(a):
        return jnp.asarray(np.broadcast_to(a, (P, cap)))

    args = (jnp.asarray(jm._host_types), jm._params_d, jm._log_noise_d)
    lml_old = np.asarray(jlml.gp_lml_batch(
        *args, rows(x_row), rows(y_rows[0]), rows(mask_old),
        jlml.DEFAULT_JITTER))
    log_w, mu = [], []
    for y_s in y_rows:
        lml_new = np.asarray(jlml.gp_lml_batch(
            *args, rows(x_row), rows(y_s), rows(mask_new),
            jlml.DEFAULT_JITTER))
        bad = (lml_new <= -1e9) | (lml_old <= -1e9)
        log_w.append(np.where(bad, -1e10,
                              jm.log_weight.astype(np.float32)
                              + lml_new - lml_old))
        m, cov = jlml.gp_predict_batch(
            *args, rows(x_row), rows(y_s), rows(mask_new),
            jnp.asarray(jm._normalize_dates(f_dates), jnp.float32),
            jlml.DEFAULT_JITTER, True)
        mu.append(np.asarray(m))
    chol = np.asarray(jlml.sampling_cholesky(cov))
    return np.stack(log_w), np.stack(mu, -1), chol


def test_shared_chol_moments_match_jax(fitted):
    jm = fitted[0]
    nc_dates, draws, f_dates = _nowcasts(S=3)
    ncs = ngp.create_nowcast_data(list(draws), nc_dates)
    ref_w, ref_mu, ref_chol = _jax_shared_chol(jm, ncs, f_dates)

    pm = GPModel.from_jax_state(jm.to_dict(), device="cpu")
    x_row, y_rows, mask_old, mask_new = nowcast._scenario_buffers(pm, ncs)
    t = pm._tensor
    log_w, mu, chol = nowcast._shared_chol_moments(
        pm._types_d(), pm._params_d, pm._log_noise_d, t(x_row), t(y_rows),
        t(mask_old), t(mask_new), t(pm.log_weight),
        t(pm._normalize_dates(f_dates)))
    np.testing.assert_allclose(log_w.numpy(), ref_w, rtol=VAL_RTOL,
                               atol=2 * VAL_ATOL)
    np.testing.assert_allclose(mu.numpy(), ref_mu, rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    c = chol.numpy()
    np.testing.assert_allclose(c @ c.transpose(0, 2, 1),
                               ref_chol @ ref_chol.transpose(0, 2, 1),
                               rtol=PRED_RTOL, atol=PRED_ATOL)


def test_forecast_draws_match_jax_in_distribution(fitted):
    """S = 4 scenarios x D = 500 draws per side from the same model state:
    per forecast date, the mean and the 5/50/95% quantiles agree within
    MC_SIGMAS standard errors (normal approximation of each statistic's
    sampling error, both sides' errors combined)."""
    jm = fitted[0]
    nc_dates, draws, f_dates = _nowcasts(S=4, seed=2)
    D = 500
    ref = jngp.forecast_with_nowcasts(
        jm, jngp.create_nowcast_data(list(draws), nc_dates), f_dates, D)
    pm = GPModel.from_jax_state(jm.to_dict(), device="cpu")
    got = ngp.forecast_with_nowcasts(
        pm, ngp.create_nowcast_data(list(draws), nc_dates), f_dates, D)
    assert got.shape == ref.shape == (HORIZON, 4 * D)
    n_draws = got.shape[1]
    sd = np.sqrt(0.5 * (got.var(1) + ref.var(1)))
    se_mean = sd * np.sqrt(2.0 / n_draws)
    assert np.all(np.abs(got.mean(1) - ref.mean(1)) <= MC_SIGMAS * se_mean)
    for q, z in ((0.05, -1.645), (0.5, 0.0), (0.95, 1.645)):
        dens = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi) / sd
        se_q = np.sqrt(2.0 * q * (1 - q) / n_draws) / dens
        diff = np.abs(np.quantile(got, q, axis=1) - np.quantile(ref, q, axis=1))
        assert np.all(diff <= MC_SIGMAS * se_q), (q, diff, se_q)


def test_tiny_end_to_end_fit_and_nowcast():
    dates, y = _series()
    obs = np.exp(y)
    fwd, inv = ngp.get_transformations("boxcox", obs[:N_TRAIN])
    data = ngp.create_transformed_data(dates[:N_TRAIN], obs[:N_TRAIN],
                                       transformation=fwd)
    model = ngp.make_and_fit_model(
        data, n_particles=P, smc_data_proportion=0.25, n_mcmc=2, n_hmc=2,
        seed=3, config=ngp.GPConfig(max_depth=3), device="cpu")
    assert model.n_ingested == N_TRAIN
    assert np.all(np.isfinite(model._lml_d.numpy()))
    nc_dates, draws, f_dates = _nowcasts(S=5)
    ncs = ngp.create_nowcast_data(list(np.exp(draws)), nc_dates,
                                  transformation=fwd)
    fc = ngp.forecast_with_nowcasts(model, ncs, f_dates, 10,
                                    inv_transformation=inv,
                                    ess_threshold=0.5)
    assert fc.shape == (HORIZON, 50)
    assert np.all(np.isfinite(fc)) and np.all(fc >= 0)
    again = ngp.forecast_with_nowcasts(model, ncs, f_dates, 10,
                                       inv_transformation=inv)
    np.testing.assert_array_equal(fc, again)  # pure function of the state


def test_hmc_prior_invariance_with_empty_mask():
    """With every data slot masked the LML is constant, so HMC must sample
    the prior: started from prior draws, the standardized active
    parameters stay N(0, 1) while the chains move."""
    cfg = ngp.GPConfig(max_depth=3)
    pm = GPModel(np.arange(32.0), np.zeros(32), n_particles=128, config=cfg,
                 seed=4, device="cpu")
    x, y, m = pm._batched_data(0)
    mu, sg, act = (pm._tensor(a) for a in prior_arrays(pm._host_types, cfg))
    noise_mu, noise_sigma, infer = pm.noise_prior
    p0 = pm._params_d.clone()
    p, ln, lml, rate, _, _ = run_hmc(
        pm._types_d(), pm._params_d, pm._log_noise_d, mu, sg, act, x, y, m,
        pm._gen, n_steps=8, n_leapfrog=5, step_size=0.8, step_jitter=0.5,
        jitter=1e-5, noise_mu=noise_mu, noise_sigma=noise_sigma,
        infer_noise=infer)
    assert torch.all(lml == 0.0)
    active = act > 0
    z = ((p - mu) / sg)[active]
    zn = (ln - noise_mu) / noise_sigma
    assert float((p != p0)[active].float().mean()) > 0.8
    assert float(rate.mean()) > 0.5
    for sample in (z, zn):
        k = sample.numel()
        assert abs(float(sample.mean())) < 5.0 / np.sqrt(k)
        assert abs(float(sample.var()) - 1.0) < 5.0 * np.sqrt(2.0 / k)


def _run_hmc_one_loop(node_types, params, log_noise, prior_mu, prior_sigma,
                      prior_active, x, y, mask, gen, *, n_steps, n_leapfrog,
                      step_size, step_jitter, jitter, noise_mu, noise_sigma,
                      infer_noise, eps_scale=None, init=None):
    """``run_hmc`` as one loop, drawing inside the trajectory: the loop
    before its body was split out, kept verbatim as the reference."""
    P = params.shape[0]
    dev = params.device
    if eps_scale is None:
        eps_scale = torch.ones(P, dtype=params.dtype, device=dev)
    potential = hmc.make_batched_potential(
        node_types, prior_mu, prior_sigma, prior_active,
        x, y, mask, jitter, noise_mu, noise_sigma, infer_noise,
    )
    if init is None:
        U0, lml, g_p, g_n = hmc._value_and_grad(potential, params, log_noise)
    else:
        U0, lml, g_p, g_n = init
    p, ln, scale = params.detach(), log_noise.detach(), eps_scale
    n_acc = torch.zeros(P, dtype=torch.float32, device=dev)
    for _ in range(n_steps):
        eps = step_size * scale * (
            1.0 + step_jitter * (
                2.0 * torch.rand(P, generator=gen, device=dev) - 1.0))
        eps3 = eps[:, None, None]
        mom_p = torch.randn(p.shape, generator=gen,
                            device=dev) * prior_active
        mom_n = torch.randn(P, generator=gen, device=dev) * infer_noise
        K0 = 0.5 * ((mom_p * mom_p).sum((1, 2)) + mom_n * mom_n)

        p_, ln_, mp, mn, gp_, gn_ = p, ln, mom_p, mom_n, g_p, g_n
        U_, lml_ = U0, lml
        for _ in range(n_leapfrog):
            mp = mp - 0.5 * eps3 * gp_ * prior_active
            mn = mn - 0.5 * eps * gn_ * infer_noise
            p_ = p_ + eps3 * mp * prior_active
            ln_ = ln_ + eps * mn * infer_noise
            U_, lml_, gp_, gn_ = hmc._value_and_grad(potential, p_, ln_)
            mp = mp - 0.5 * eps3 * gp_ * prior_active
            mn = mn - 0.5 * eps * gn_ * infer_noise
        K1 = 0.5 * ((mp * mp).sum((1, 2)) + mn * mn)
        dH = (U0 + K0) - (U_ + K1)
        u = torch.rand(P, generator=gen, device=dev)
        ok = torch.isfinite(dH) & (
            torch.log(u) < torch.clamp_max(dH, 0.0))
        ok3 = ok[:, None, None]
        p = torch.where(ok3, p_, p)
        ln = torch.where(ok, ln_, ln)
        U0 = torch.where(ok, U_, U0)
        lml = torch.where(ok, lml_, lml)
        g_p = torch.where(ok3, gp_, g_p)
        g_n = torch.where(ok, gn_, g_n)
        okf = ok.to(scale.dtype)
        scale = torch.clamp(
            scale * torch.exp(hmc._ADAPT_RATE * (okf - hmc._TARGET_ACCEPT)),
            *hmc._SCALE_BOUNDS)
        n_acc = n_acc + okf
    rate = n_acc / max(n_steps, 1)
    return p, ln, lml, rate, scale, (U0, g_p, g_n)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("given_init", [False, True])
def test_run_hmc_split_keeps_the_draws(n_steps, given_init):
    """The trajectory body with its draws taken up front, as the eager
    loop runs it, equals the one-loop version bit for bit on a CPU
    generator: the random stream and the arithmetic are unchanged.  The
    counts say every trajectory ran eagerly."""
    dates, y = _series()
    pm = GPModel(dates[:N_TRAIN], y[:N_TRAIN], n_particles=P,
                 config=ngp.GPConfig(max_depth=3), seed=3, device="cpu")
    x, yb, m = pm._batched_data()
    mu, sg, act = (pm._tensor(a) for a in prior_arrays(pm._host_types,
                                                       pm.config))
    noise_mu, noise_sigma, infer = pm.noise_prior
    kw = dict(n_steps=n_steps, n_leapfrog=4, step_size=0.3,
              step_jitter=0.5, jitter=1e-5, noise_mu=noise_mu,
              noise_sigma=noise_sigma, infer_noise=infer,
              eps_scale=torch.linspace(0.5, 2.0, P))
    args = (pm._types_d(), pm._params_d, pm._log_noise_d, mu, sg, act, x,
            yb, m)
    if given_init:
        pot = hmc.make_batched_potential(*args[:1], mu, sg, act, x, yb, m,
                                         1e-5, noise_mu, noise_sigma, infer)
        kw["init"] = hmc._value_and_grad(pot, pm._params_d, pm._log_noise_d)
    outs = []
    with profiling.recording() as rec:
        for fn in (_run_hmc_one_loop, run_hmc):
            gen = torch.Generator().manual_seed(11)
            outs.append(fn(*args, gen, **kw))
            outs[-1] += (gen.get_state(),)
    want, got = (list(o[:5]) + list(o[5]) + [o[6]] for o in outs)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert dict(rec.counts) == {"hmc/eager_trajectories": n_steps}


def test_graph_engagement_rule():
    """The graph engages on the card where one LML call's budget is at most
    half a call's: the fits' fused core, the daily cell's composed core at
    576 and the refresh's 20,000 rows at 160; never on a CPU tensor, nor
    where the composed core runs in chunks or a call is larger."""
    chunk = composed_chunk(2208)
    assert not hmc._uses_graph("cpu", 200, 160)
    assert not hmc._uses_graph("cpu", 16, 576)
    assert hmc._uses_graph("cuda", 200, 32)
    assert hmc._uses_graph("cuda", 1272, 160)
    assert hmc._uses_graph("cuda", 20000, 160)
    assert hmc._uses_graph("cuda", 200, 576)
    assert hmc._uses_graph("cuda", 32, 2208)
    assert not hmc._uses_graph("cuda", 3200, 576)
    assert not hmc._uses_graph("cuda", chunk + 1, 2208)


def test_unported_paths_raise():
    """What the port does not port raises and names ROADMAP.md: the JAX
    package's "jnp" LML backend.  Capacities beyond 2048 run (the composed
    core in particle chunks): with every point masked, A is the identity
    and the core is 0."""
    dates, y = _series()
    pm = GPModel(dates[:N_TRAIN], y[:N_TRAIN], n_particles=2,
                 config=ngp.GPConfig(max_depth=2), seed=1, device="cpu")
    x, ym, mask = (torch.zeros(2, 2080) for _ in range(3))
    with torch.no_grad():
        core = lml_core(pm._types_d(), pm._params_d, torch.ones(2, 2080),
                        mask, x, ym)
    assert torch.equal(core, torch.zeros(2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        set_lml_backend("jnp")
