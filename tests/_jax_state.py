"""The JAX model state several port parity files start from, built once.

P = 8 depth-3 particles (JAX package, seed 5) reweighted on the first 24
weeks of ``log(800 exp(0.6 sin(2 pi t / 26 + 1) + 0.12 z))``, z from
``default_rng(0)``: ``tests/test_torch_forecast.py``,
``test_torch_forecast_hmc.py``, ``test_torch_nowcast_refresh.py`` and
``test_torch_workflow.py`` hold the port against it, each with its own
forecast dates after week 24.  ``jax_weekly_state`` returns its
``to_dict()``, built by one worker a session (``_session_once``).
"""

import datetime as dt

import numpy as np
from _session_once import once_per_session

P, N_TRAIN = 8, 24


def weekly_series(n, seed=0):
    """Dates and log values of the series (the first ``N_TRAIN`` do not
    depend on ``n``)."""
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    obs = 800 * np.exp(0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
                       + 0.12 * rng.standard_normal(n))
    return dates, np.log(obs)


def _build():
    import nowcastautogp_tpu as jngp

    dates, y = weekly_series(N_TRAIN)
    jm = jngp.GPModel(dates, y, n_particles=P,
                      config=jngp.GPConfig(max_depth=3), seed=5)
    jm.reweight_to(N_TRAIN)
    return jm.to_dict()


def jax_weekly_state(tmp_path_factory):
    return once_per_session(tmp_path_factory, "jax_weekly_state", _build)
