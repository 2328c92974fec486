"""Port parity: the host layer is bitwise equal to the JAX package's.

Structures (prior sampling, prior arrays, the three proposals through
``propose_batch``), transforms, data containers, dates, schedules and
resampling run numpy in both packages, so for the same numpy seed they must
return identical arrays.  Also checks that importing the port loads neither
jax nor the JAX package, and that the kernels' launch counters stay exact
when several host threads launch at once: a test forces the interpreter to
switch threads between the bytecodes of every bump, which loses counts from
any unsynchronised read-modify-write.
"""

import datetime as dt
import re
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nowcastautogp_tpu_torch as port
from nowcastautogp_tpu import fitting as jfitting
from nowcastautogp_tpu import tdata as jtdata
from nowcastautogp_tpu import transforms as jtransforms
from nowcastautogp_tpu.inference import resample as jresample
from nowcastautogp_tpu.inference import schedule as jschedule
from nowcastautogp_tpu.inference import structure_mcmc as jmcmc
from nowcastautogp_tpu.models import config as jconfig
from nowcastautogp_tpu.eval import crps as jcrps
from nowcastautogp_tpu.eval import families as jfamilies
from nowcastautogp_tpu.models import structures as jstructures
from nowcastautogp_tpu.utils import dates as jdates
from nowcastautogp_tpu_torch import fitting, tdata, transforms
from nowcastautogp_tpu_torch.eval import crps, families
from nowcastautogp_tpu_torch.inference import resample, schedule
from nowcastautogp_tpu_torch.inference import structure_mcmc
from nowcastautogp_tpu_torch.models import config, structures
from nowcastautogp_tpu_torch.ops import cudalib, megalml
from nowcastautogp_tpu_torch.utils import dates

torch.set_num_threads(1)

PKG = Path(port.__file__).resolve().parent


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


def _population(mod, cfg_mod, depth, P, seed):
    cfg = cfg_mod.GPConfig(max_depth=depth)
    rng = np.random.default_rng(seed)
    parts = [mod.sample_particle(rng, cfg) for _ in range(P)]
    return cfg, rng, parts


@pytest.mark.parametrize("depth", [3, 5])
def test_sample_particle_and_prior_arrays_bitwise(depth):
    cfg_p, _, got = _population(structures, config, depth, 40, seed=depth)
    cfg_j, _, ref = _population(jstructures, jconfig, depth, 40, seed=depth)
    _assert_same(tuple(map(tuple, got)), tuple(map(tuple, ref)))
    types = np.stack([t for t, _, _ in got])
    _assert_same(structures.prior_arrays(types, cfg_p),
                 jstructures.prior_arrays(types, cfg_j))
    assert ([structures.structure_to_str(t) for t in types]
            == [jstructures.structure_to_str(t) for t in types])


@pytest.mark.parametrize("depth", [3, 5])
def test_propose_batch_bitwise(depth):
    """Several rounds of proposals for a population, each round fed the
    previous round's proposals: types, params, log-Hastings and prior
    arrays stay identical."""
    cfg_p, rng_p, parts = _population(structures, config, depth, 24, seed=7)
    cfg_j, rng_j, _ = _population(jstructures, jconfig, depth, 24, seed=7)
    types = np.stack([t for t, _, _ in parts]).astype(np.int32)
    params = np.stack([p for _, p, _ in parts])
    assert structure_mcmc.MOVE_PROBS == (0.4, 0.3, 0.3)
    for _ in range(4):
        got = structure_mcmc.propose_batch(rng_p, types, params, cfg_p)
        ref = jmcmc.propose_batch(rng_j, types, params, cfg_j)
        _assert_same(got, ref)
        types, params = got[0], got[1]


@pytest.mark.parametrize("name", ["boxcox", "positive", "percentage"])
def test_transforms_bitwise(name):
    rng = np.random.default_rng(3)
    values = rng.gamma(2.0, 20.0, 60)
    if name == "percentage":
        values = 90.0 * values / values.max()
    values[5] = 0.0  # exercises the offset rule
    fwd_p, inv_p = transforms.get_transformations(name, values)
    fwd_j, inv_j = jtransforms.get_transformations(name, values)
    _assert_same(fwd_p(values), fwd_j(values))
    z = np.concatenate([fwd_j(values), rng.normal(0, 30, 20), [-1e6, 1e6]])
    _assert_same(inv_p(z), inv_j(z))
    assert inv_p(1.5) == inv_j(1.5)


def test_transform_guards_bitwise():
    """The issue-51 degenerate Box-Cox fallback and the inverse clamps."""
    flat = np.full(30, 7.0) + 1e-9 * np.arange(30)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fp, ip = transforms.get_transformations("boxcox", flat)
        fj, ij = jtransforms.get_transformations("boxcox", flat)
    _assert_same(fp(flat), fj(flat))
    for lam in (-2.0, 0.0, 0.5):
        y = np.linspace(-5.0, 5.0, 41)
        _assert_same(transforms._inv_boxcox(lam, 0.5, 80.0)(y),
                     jtransforms._inv_boxcox(lam, 0.5, 80.0)(y))
    with pytest.raises(AssertionError):
        transforms.get_transformations("nope", [1.0])


def test_data_containers_and_dates_bitwise():
    ds = [dt.date(2023, 1, 2) + dt.timedelta(weeks=i) for i in range(12)]
    vals = np.linspace(3.0, 40.0, 12)
    a = tdata.create_transformed_data(ds, vals, transformation=np.log)
    b = jtdata.create_transformed_data(ds, vals, transformation=np.log)
    _assert_same((a.y, a.values), (b.y, b.values))
    for axis in (ds, np.array(ds, dtype="datetime64[D]"), np.arange(5.0)):
        _assert_same(dates.dates_to_float(axis), jdates.dates_to_float(axis))


@pytest.mark.parametrize("n,prop", [(150, 0.1), (24, 0.25), (7, 0.5), (1, 1.0)])
def test_linear_schedule_bitwise(n, prop):
    assert schedule.linear_schedule(n, prop) == jschedule.linear_schedule(n, prop)


@pytest.mark.parametrize("method", ["systematic", "multinomial", "residual"])
def test_resample_bitwise(method):
    lw = np.random.default_rng(11).normal(0.0, 2.0, 50)
    assert resample.ess(lw) == jresample.ess(lw)
    got = resample.resample_indices(np.random.default_rng(5), lw, method)
    ref = jresample.resample_indices(np.random.default_rng(5), lw, method)
    _assert_same(got, ref)
    state = np.random.default_rng(6).normal(size=(50, 7, 3)).astype(np.float32)
    g = resample.gather_particles((torch.tensor(state),),
                                  torch.tensor(got, dtype=torch.long))
    r = jresample.gather_particles((jnp.asarray(state),), jnp.asarray(ref))
    _assert_same(g[0].numpy(), np.asarray(r[0]))


def test_stabilize_for_fit_bitwise():
    y = np.linspace(1.0, 2.0, 20)
    assert fitting._stabilize_for_fit(y) is y
    flat = np.full(20, 3.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = fitting._stabilize_for_fit(flat, rng=np.random.default_rng(1))
        ref = jfitting._stabilize_for_fit(flat, rng=np.random.default_rng(1))
    _assert_same(got, ref)


def test_crps_and_quantiles_match_jax():
    rng = np.random.default_rng(8)
    fc = rng.lognormal(5.0, 0.3, (6, 400))
    obs = rng.lognormal(5.0, 0.3, 6)
    _assert_same(crps.crps_matrix(fc, obs), jcrps.crps_matrix(fc, obs))
    assert crps.crps_ensemble(fc[0], obs[0]) == jcrps.crps_ensemble(fc[0],
                                                                    obs[0])
    qs = [0.05, 0.5, 0.95]
    _assert_same(crps.quantile_matrix(fc, qs), jcrps.quantile_matrix(fc, qs))
    # float32 on the device, as the JAX package's device quantiles
    np.testing.assert_allclose(
        crps.quantile_matrix_device(fc, qs, device="cpu"),
        jcrps.quantile_matrix(fc, qs), rtol=1e-5)


@pytest.mark.parametrize("family", ["nhsn_like", "seir_wave", "outbreak_cp"])
def test_series_families_bitwise(family):
    for seed in (2, 3, 4):
        _assert_same(families.FAMILIES[family](150, seed),
                     jfamilies.FAMILIES[family](150, seed))


def test_import_loads_no_jax():
    """A fresh interpreter importing the port, and each of the workflow
    modules by name, loads neither jax nor the JAX package, and no module
    of the port (nor the jax-free scripts ``chip_smoke.py``,
    ``bench_torch.py`` and ``profile_fit.py``) names jax in an import."""
    modules = ("parallel.panel", "eval.acceptance", "eval.wis",
               "eval.submission", "models.decompose", "utils.data",
               "utils.profiling", "utils.serialize")
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import nowcastautogp_tpu_torch\n"
        + "".join(f"import nowcastautogp_tpu_torch.{m}\n" for m in modules)
        + "new = set(sys.modules) - before\n"
        "assert all(f'nowcastautogp_tpu_torch.{m}' in new for m in "
        f"{modules!r})\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nowcastautogp_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PKG.parent, timeout=120)
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|nowcastautogp_tpu)\b")
    scripts = [PKG.parent / name for name in ("chip_smoke.py",
                                              "bench_torch.py",
                                              "profile_fit.py")]
    for path in [*PKG.rglob("*.py"), *scripts]:
        for line in path.read_text().splitlines():
            assert not banned.match(line), (path, line)


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


def test_failed_kernel_build_stops_the_other_compilers(tmp_path, monkeypatch):
    """When one source fails to compile, ``build_library`` raises at once:
    the compilers still running are stopped, never waited on while their
    output pipes are unread (a compiler that fills its pipe would block
    forever).  A stand-in nvcc fails on a.cu and writes 200 KB for b.cu."""
    import threading

    from nowcastautogp_tpu_torch.ops import cudalib

    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu"):
        (src / name).write_text("// stand-in source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\ncase "$*" in\n  *a.cu*) echo "a.cu: error"; '
                    'exit 1 ;;\n  *) head -c 200000 /dev/zero | tr "\\0" x; '
                    'exit 0 ;;\nesac\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cudalib, "_CSRC", src)
    monkeypatch.setattr(cudalib, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cudalib, "_nvcc", lambda: str(nvcc))
    errors = []

    def build():
        try:
            cudalib.build_library()
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=build, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "build_library hung after a failed compile"
    assert errors and "a.cu" in errors[0]
