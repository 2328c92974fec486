"""The CUDA kernels (K1-K7) against their plain versions, on an NVIDIA card.

Skipped where torch sees no CUDA device (the CPU test run); on a machine
with a card run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports jax, which the port does not need).  Inputs
are depth-5 heaps that together hold all 8 node types, with well-conditioned
covariances, so the float32 tolerances of the JAX package's fused-kernel
tests apply directly.
"""

import numpy as np
import pytest
import torch

from nowcastautogp_tpu_torch.models import structures as st
from nowcastautogp_tpu_torch.ops import (
    chol, chol_mxu, cov, lml, megacov, megalml,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

VAL_RTOL, VAL_ATOL = 2e-4, 2e-3
GRAD_RTOL, GRAD_ATOL = 3e-3, 3e-3

_TREES = [
    {0: st.CONST}, {0: st.SE}, {0: st.LINEAR}, {0: st.GE}, {0: st.PERIODIC},
    {0: st.PLUS, 1: st.SE, 2: st.PERIODIC},
    {0: st.TIMES, 1: st.LINEAR, 2: st.GE},
    {0: st.CP, 1: st.SE, 2: st.CONST},
    {0: st.CP, 1: st.PLUS, 2: st.TIMES, 3: st.GE, 4: st.TIMES, 5: st.SE,
     6: st.CONST, 9: st.PERIODIC, 10: st.LINEAR},
]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(dev, n=96, n_active=80, seed=0):
    rng = np.random.default_rng(seed)
    P = len(_TREES)
    types = np.zeros((P, 31), np.int32)
    for i, tree in enumerate(_TREES):
        for slot, t in tree.items():
            types[i, slot] = t
    params = rng.normal(0.0, 0.5, (P, 31, 3)).astype(np.float32)
    params[types == 0] = 0.0
    mask = np.broadcast_to((np.arange(n) < n_active).astype(np.float32),
                           (P, n))
    diagv = mask * (np.exp(rng.normal(-2.0, 0.3, (P, 1))) + 1e-5) + (1 - mask)
    x = np.broadcast_to(np.linspace(0, 1, n), (P, n))
    ym = rng.normal(0.0, 1.0, (P, n)) * mask

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return t(types, torch.int32), t(params), t(diagv), t(mask), t(x), t(ym)


def _plain(args):
    types, params, diagv, mask, x, ym = args
    p, d, y = (a.clone().requires_grad_(True) for a in (params, diagv, ym))
    core = megalml.lml_core_plain(types, p, d, mask, x, y)
    gp, gd, gy = torch.autograd.grad(core.sum(), (p, d, y))
    return core.detach(), gp, gd, -gy


def test_value_kernel_matches_plain(dev):
    args = _batch(dev)
    got = megalml.megalml_val(*args)
    ref = _plain(args)[0]
    torch.testing.assert_close(got, ref, rtol=VAL_RTOL, atol=VAL_ATOL)


def test_gradient_kernel_value_is_bitwise_value_kernel(dev):
    args = _batch(dev)
    a = megalml.megalml_val(*args)
    b = megalml.megalml_vag(*args)[0]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_gradient_kernel_matches_autograd_of_plain(dev):
    args = _batch(dev)
    _, dp, gd, al = megalml.megalml_vag(*args)
    _, rdp, rgd, ral = _plain(args)
    for got, ref in ((dp, rdp), (gd, rgd), (al, ral)):
        torch.testing.assert_close(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _within_per_particle_rule(got, r32, r64, rtol, atol, factor=10.0):
    """chip_smoke's rule: each particle's error / tolerance against float64
    is at most max(1, factor x float32 plain's)."""
    k, p32, p64 = (t.double().reshape(t.shape[0], -1) for t in (got, r32, r64))
    tol = atol + rtol * p64.abs()
    rk = ((k - p64).abs() / tol).amax(1)
    rp = ((p32 - p64).abs() / tol).amax(1)
    return bool((rk <= torch.clamp_min(factor * rp, 1.0)).all())


@pytest.mark.parametrize("n", [96, 160, 512])
def test_gradient_kernel_matches_float64_plain_per_particle(dev, n):
    """K1 on the blocked engine at the weekly (96, 160) and daily (512)
    capacities: value and gradients against the float64 plain version, the
    value bitwise K2's, and two launches bitwise equal."""
    args = _batch(dev, n=n, n_active=n - 13, seed=n)
    got = megalml.megalml_vag(*args)
    again = megalml.megalml_vag(*args)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(got[0].view(torch.int32),
                       megalml.megalml_val(*args).view(torch.int32))
    ref32 = _plain(args)
    ref64 = _plain(tuple(a.double() if a.is_floating_point() else a
                         for a in args))
    assert _within_per_particle_rule(got[0], ref32[0], ref64[0], VAL_RTOL,
                                     VAL_ATOL)
    for g, r32, r64 in zip(got[1:], ref32[1:], ref64[1:]):
        assert _within_per_particle_rule(g, r32, r64, GRAD_RTOL, GRAD_ATOL)


def test_autograd_function_picks_the_kernel(dev):
    types, params, diagv, mask, x, ym = _batch(dev)
    log_noise = torch.full((types.shape[0],), -2.0, device=dev)
    megalml.reset_launch_counts()
    with torch.no_grad():
        lml.gp_lml_batched(types, params, log_noise, x, ym, mask)
    assert (megalml.K1_LAUNCHES, megalml.K2_LAUNCHES) == (0, 1)
    p = params.clone().requires_grad_(True)
    ln = log_noise.clone().requires_grad_(True)
    out = lml.gp_lml_batched(types, p, ln, x, ym, mask)
    out.sum().backward()
    assert (megalml.K1_LAUNCHES, megalml.K2_LAUNCHES) == (1, 1)
    p_ref = params.clone().requires_grad_(True)
    ln_ref = log_noise.clone().requires_grad_(True)
    ref = lml.gp_lml_batched(types.cpu(), p_ref.cpu(), ln_ref.cpu(), x.cpu(),
                             ym.cpu(), mask.cpu())
    ref.sum().backward()
    torch.testing.assert_close(out.detach().cpu(), ref.detach(),
                               rtol=VAL_RTOL, atol=VAL_ATOL)
    # the CPU reference's gradients land on its CUDA leaves
    torch.testing.assert_close(p.grad, p_ref.grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    torch.testing.assert_close(ln.grad, ln_ref.grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_non_spd_particle_is_nan_in_its_lane_only(dev):
    args = _batch(dev)
    types, params = args[0].clone(), args[1].clone()
    types[2] = 0
    types[2, 0] = st.CONST
    params[2] = 0.0
    params[2, 0, 0] = 100.0  # exp(100) = inf in float32
    keep = torch.arange(types.shape[0], device=dev) != 2
    base = megalml.megalml_val(*args)
    for core in (megalml.megalml_val(types, params, *args[2:]),
                 megalml.megalml_vag(types, params, *args[2:])[0]):
        assert torch.isnan(core[2])
        assert torch.equal(core[keep], base[keep])


def test_outside_the_envelope_raises(dev):
    """n = 4104 is beyond K4/K5's envelope and raises; n = 544 and 2080
    take the composed core (K4 once, no K1/K2)."""
    for n, runs in ((4104, False), (2080, True), (544, True)):
        types, params, diagv, mask, x, ym = _batch(dev, n=n, n_active=n - 9)
        log_noise = torch.full((types.shape[0],), -2.0, device=dev)
        if not runs:
            with pytest.raises(NotImplementedError, match="4096"):
                lml.gp_lml_batched(types, params, log_noise, x, ym, mask)
            continue
        megalml.reset_launch_counts()
        megacov.reset_launch_counts()
        out = lml.gp_lml_batched(types, params, log_noise, x, ym, mask)
        assert torch.isfinite(out).all()
        assert (megalml.K1_LAUNCHES, megalml.K2_LAUNCHES) == (0, 0)
        assert megacov.K4_LAUNCHES == 1


def _spd(dev, n, n_active, seed=1):
    """Masked A of the hand batch (well conditioned) and its target."""
    types, params, diagv, mask, x, ym = _batch(dev, n=n, n_active=n_active,
                                               seed=seed)
    K = megacov.megacov_fwd_plain(types, params, x)
    A = K * (mask[:, :, None] * mask[:, None, :]) + torch.diag_embed(diagv)
    return (types, params, x), A.contiguous(), ym


@pytest.mark.parametrize("N", [31, 63])
def test_vjp_launch_plans_agree_bitwise(dev, N):
    """K5 and K7B take one launch per heap class on a large grid and two
    class-switched launches on a small one (covtile.cuh's
    CLASS_LAUNCH_BLOCKS): 150 particles of every class at n = 512 (20,400
    blocks) against the same particles 6 at a time (816 blocks), bitwise."""
    classes = [c for c in (1, 3, 7, 15, 31, 63) if c <= N]
    P, n = 150, 512
    types = torch.tensor(np.stack([_chain_heap(classes[i % len(classes)] - 1,
                                               N) for i in range(P)]),
                         device=dev)
    rng = np.random.default_rng(N)
    params = torch.tensor(rng.normal(0.0, 0.5, (P, N, 3)),
                          dtype=torch.float32, device=dev)
    x = torch.linspace(0, 1, n, device=dev)
    xp = x.expand(P, n).contiguous()
    dK = torch.randn((P, n, n), generator=torch.Generator(dev).manual_seed(N),
                     device=dev)
    for fn in (lambda s: cov.cov_bwd(types[s], params[s], x, x, dK[s]),
               lambda s: megacov.megacov_bwd(types[s], params[s], xp[s],
                                             dK[s])):
        whole = fn(slice(None))
        parts = torch.cat([fn(slice(i, i + 6)) for i in range(0, P, 6)])
        assert torch.equal(whole, parts)


@pytest.mark.parametrize("n", [96, 576])
def test_covariance_kernels_match_plain(dev, n):
    (types, params, x), _, _ = _spd(dev, n, n - 11)
    K = megacov.megacov_fwd(types, params, x)
    torch.testing.assert_close(K, megacov.megacov_fwd_plain(types, params, x),
                               rtol=1e-5, atol=1e-5)
    dK = torch.randn(K.shape, generator=torch.Generator(dev).manual_seed(n),
                     device=dev)
    got = megacov.megacov_bwd(types, params, x, dK)
    ref = megacov.megacov_bwd_plain(types, params, x, dK)
    tol = 2e-4 if n <= 128 else 2e-3
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    assert torch.equal(got, megacov.megacov_bwd(types, params, x, dK))
    assert torch.equal(K, megacov.megacov_fwd(types, params, x))


def test_k4_is_k7f_symmetric_path(dev):
    """K4 (per-particle x) and K7F's symmetric path (one shared x) run the
    same tile code: bitwise the same covariance at the nowcast's n = 160."""
    types, params = _batch(dev)[:2]
    x = torch.linspace(0, 1, 160, device=dev)
    K4 = megacov.megacov_fwd(types, params,
                             x.expand(types.shape[0], 160).contiguous())
    assert torch.equal(K4, cov.cov_fwd(types, params, x, x))


@pytest.mark.parametrize("n", [96, 576, 1024])
def test_inverse_kernel_matches_plain(dev, n):
    _, A, ym = _spd(dev, n, n - 11)
    X = chol_mxu.tri_inv(A)
    ref = chol_mxu.tri_inv_plain(A.double())
    scale = ref.abs().amax((1, 2), keepdim=True)
    torch.testing.assert_close(X.double() / scale, ref / scale, rtol=1e-3,
                               atol=1e-4)
    assert torch.equal(X, torch.tril(X))
    assert torch.equal(X, chol_mxu.tri_inv(A))
    bad = A.clone()
    bad[2, 7, 7] = -1.0
    Xb = chol_mxu.tri_inv(bad)
    keep = torch.arange(A.shape[0], device=dev) != 2
    assert torch.isnan(Xb[2]).any()
    assert torch.equal(Xb[keep], X[keep])


def test_composed_lml_runs_k4_k3_k5(dev):
    types, params, diagv, mask, x, ym = _batch(dev, n=576, n_active=563)
    for mod in (megacov, chol_mxu):
        mod.reset_launch_counts()
    p = params.clone().requires_grad_(True)
    out = lml.lml_core(types, p, diagv, mask, x, ym)
    out.sum().backward()
    assert (megacov.K4_LAUNCHES, chol_mxu.K3_LAUNCHES,
            megacov.K5_LAUNCHES) == (1, 1, 1)
    # the plain version on the CPU in float64 (reference) and float32:
    # at n = 576 a near-rank-one covariance (the lone Constant of particle
    # 0) leaves float32 gradients of any inverse-based core ill
    # conditioned, so the kernels' error is held per particle to
    # max(tolerance, 10 x float32 plain's), as chip_smoke.py does
    ref = {}
    for dtype in (torch.float64, torch.float32):
        p_ref = params.cpu().to(dtype).requires_grad_(True)
        val = lml.lml_core(types.cpu(), p_ref, *(
            a.cpu().to(dtype) for a in (diagv, mask, x, ym)))
        val.sum().backward()
        ref[dtype] = (val.detach().double(), p_ref.grad.double())
    got = (out.detach().double().cpu(), p.grad.double().cpu())
    for i, (rtol, atol) in enumerate(((VAL_RTOL, VAL_ATOL),
                                      (GRAD_RTOL, GRAD_ATOL))):
        r64, r32, k = ref[torch.float64][i], ref[torch.float32][i], got[i]
        tol = atol + rtol * r64.abs()
        rk = ((k - r64).abs() / tol).reshape(k.shape[0], -1).amax(1)
        rp = ((r32 - r64).abs() / tol).reshape(k.shape[0], -1).amax(1)
        assert bool((rk <= torch.clamp_min(10.0 * rp, 1.0)).all()), (i, rk, rp)


@pytest.fixture
def pallas_backends():
    """Both "pallas" backends for one test, restored after it."""
    saved = lml._LML_BACKEND, cov._COV_BACKEND
    lml.set_lml_backend("pallas")
    cov.set_cov_backend("pallas")
    yield
    lml._LML_BACKEND, cov._COV_BACKEND = saved


@pytest.mark.parametrize("n,m,per1,per2", [
    (96, 8, True, False), (40, 56, False, True), (8, 8, False, False),
    (160, 160, True, True), (512, 512, False, False),
])
def test_rectangular_covariance_kernels_match_plain(dev, n, m, per1, per2):
    types, params = _batch(dev)[:2]
    P = types.shape[0]
    gen = torch.Generator(dev).manual_seed(n + m)
    x1 = torch.rand((P, n) if per1 else (n,), generator=gen,
                    device=dev).sort(-1).values
    x2 = 0.5 + torch.rand((P, m) if per2 else (m,), generator=gen,
                          device=dev).sort(-1).values
    K = cov.cov_fwd(types, params, x1, x2)
    torch.testing.assert_close(K, cov.cov_fwd_plain(types, params, x1, x2),
                               rtol=1e-5, atol=1e-5)
    dK = torch.randn((P, n, m), generator=gen, device=dev)
    got = cov.cov_bwd(types, params, x1, x2, dK)
    ref = cov.cov_bwd_plain(types, params, x1, x2, dK)
    tol = 2e-4 if n * m <= 160 * 160 else 2e-3
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    assert torch.equal(got, cov.cov_bwd(types, params, x1, x2, dK))


def _chain_heap(top, N):
    """A valid tree whose highest live slot is ``top`` (the last slot of its
    level): operators down the right spine, a leaf beside each."""
    types = np.zeros(N, np.int32)
    ops, leaves = (st.PLUS, st.TIMES, st.CP), (st.SE, st.CONST, st.LINEAR,
                                                st.GE, st.PERIODIC)
    k, depth = 0, 0
    while k < top:
        types[k] = ops[depth % 3]
        types[2 * k + 1] = leaves[depth % 5]
        k, depth = 2 * k + 2, depth + 1
    types[k] = leaves[(depth + 2) % 5]
    return types


@pytest.mark.parametrize("n", [8, 96, 160])
def test_symmetric_and_general_paths(dev, n):
    """K(x, x) of one buffer (symmetric path) against x2 a copy of x1
    (general path): K7F bitwise the same, K7B on both paths against plain
    with an asymmetric cotangent, both bitwise over two launches."""
    types, params = _batch(dev)[:2]
    P = types.shape[0]
    x = torch.linspace(0, 1, n, device=dev)
    K = cov.cov_fwd(types, params, x, x)
    assert torch.equal(K, cov.cov_fwd(types, params, x, x.clone()))
    torch.testing.assert_close(K, cov.cov_fwd_plain(types, params, x, x),
                               rtol=1e-5, atol=1e-5)
    dK = torch.randn((P, n, n), generator=torch.Generator(dev).manual_seed(n),
                     device=dev)
    ref = cov.cov_bwd_plain(types, params, x, x, dK)
    for x2 in (x, x.clone()):
        got = cov.cov_bwd(types, params, x, x2, dK)
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
        assert torch.equal(got, cov.cov_bwd(types, params, x, x2, dK))
    assert torch.equal(K, cov.cov_fwd(types, params, x, x))


@pytest.mark.parametrize("N", [7, 15, 31, 63])
def test_every_heap_class(dev, N):
    """Trees of every class up to the heap size N: K7F/K7B on the symmetric
    and general paths, K4/K5."""
    classes = [c for c in (1, 3, 7, 15, 31, 63) if c <= N]
    types = torch.tensor(np.stack([_chain_heap(c - 1, N) for c in classes]),
                         device=dev)
    assert cov.heap_class(types).tolist() == classes
    rng = np.random.default_rng(N)
    params = torch.tensor(rng.normal(0.0, 0.5, (len(classes), N, 3)),
                          dtype=torch.float32, device=dev)
    x = torch.linspace(0, 1, 40, device=dev)
    xs = torch.linspace(1.0, 1.1, 8, device=dev)
    for x2 in (x, xs):
        K = cov.cov_fwd(types, params, x, x2)
        torch.testing.assert_close(K, cov.cov_fwd_plain(types, params, x, x2),
                                   rtol=1e-5, atol=1e-5)
        dK = torch.randn(K.shape, generator=torch.Generator(dev).manual_seed(1),
                         device=dev)
        got = cov.cov_bwd(types, params, x, x2, dK)
        torch.testing.assert_close(
            got, cov.cov_bwd_plain(types, params, x, x2, dK), rtol=2e-4,
            atol=2e-4)
        for i, c in enumerate(classes):
            assert not got[i, c:].any()
    # K4/K5 (one launch per class) at n = 96 and a ragged n = 584 (584 % 32
    # = 8), an asymmetric cotangent; both bitwise over two launches
    for n in (96, 584):
        x = torch.linspace(0, 1, n, device=dev).expand(len(classes), n)
        x = x.contiguous()
        K = megacov.megacov_fwd(types, params, x)
        torch.testing.assert_close(
            K, megacov.megacov_fwd_plain(types, params, x), rtol=1e-5,
            atol=1e-5)
        dK = torch.randn(K.shape, generator=torch.Generator(dev).manual_seed(n),
                         device=dev)
        got = megacov.megacov_bwd(types, params, x, dK)
        tol = 2e-4 if n <= 128 else 2e-3
        torch.testing.assert_close(
            got, megacov.megacov_bwd_plain(types, params, x, dK), rtol=tol,
            atol=tol)
        for i, c in enumerate(classes):
            assert not got[i, c:].any()
        assert torch.equal(K, megacov.megacov_fwd(types, params, x))
        assert torch.equal(got, megacov.megacov_bwd(types, params, x, dK))


@pytest.mark.parametrize("n", [96, 576])
def test_cholesky_kernels_match_plain(dev, n):
    _, A, ym = _spd(dev, n, n - 11)
    L, alpha = chol.chol_solve_batched(A, ym)
    L64, a64 = chol.chol_solve_plain(A.double(), ym.double())
    assert torch.equal(L, torch.tril(L))
    for got, ref in ((L, L64), (alpha, a64)):
        scale = ref.abs().flatten(1).amax(1).reshape(-1, *[1] * (ref.dim() - 1))
        torch.testing.assert_close(got.double() / scale, ref / scale,
                                   rtol=1e-3, atol=1e-4)
    X = chol.tri_inverse(L)
    X64 = chol.tri_inverse_plain(L64)
    scale = X64.abs().amax((1, 2), keepdim=True)
    torch.testing.assert_close(X.double() / scale, X64 / scale, rtol=1e-3,
                               atol=1e-4)
    assert torch.equal(X, torch.tril(X))
    again = chol.chol_solve_batched(A, ym)
    assert torch.equal(L, again[0]) and torch.equal(alpha, again[1])
    assert torch.equal(X, chol.tri_inverse(L))
    bad = A.clone()
    bad[2, 7, 7] = -1.0
    Lb, ab = chol.chol_solve_batched(bad, ym)
    keep = torch.arange(A.shape[0], device=dev) != 2
    assert torch.isnan(ab[2]).any()
    assert torch.equal(Lb[keep], L[keep]) and torch.equal(ab[keep], alpha[keep])
    with pytest.raises(ValueError, match="multiple of 32"):
        chol.chol_solve_batched(A[:, :40, :40].contiguous(),
                                ym[:, :40].contiguous())


def test_pallas_backends_run_k7_and_k6(dev, pallas_backends):
    types, params, diagv, mask, x, ym = _batch(dev, n=160, n_active=147)
    log_noise = torch.full((types.shape[0],), -2.0, device=dev)
    for mod in (cov, chol, megalml, megacov):
        mod.reset_launch_counts()
    with torch.no_grad():
        val = lml.gp_lml_batched(types, params, log_noise, x, ym, mask)
    assert (cov.K7F_LAUNCHES, chol.K6A_LAUNCHES, chol.K6B_LAUNCHES,
            cov.K7B_LAUNCHES) == (1, 1, 0, 0)
    p = params.clone().requires_grad_(True)
    ln = log_noise.clone().requires_grad_(True)
    out = lml.gp_lml_batched(types, p, ln, x, ym, mask)
    out.sum().backward()
    assert (cov.K7F_LAUNCHES, chol.K6A_LAUNCHES, chol.K6B_LAUNCHES,
            cov.K7B_LAUNCHES) == (2, 2, 1, 1)
    assert (megalml.K1_LAUNCHES, megalml.K2_LAUNCHES,
            megacov.K4_LAUNCHES) == (0, 0, 0)
    assert torch.equal(out.detach(), val)  # one core for values and gradients
    p_ref = params.cpu().requires_grad_(True)
    ln_ref = log_noise.cpu().requires_grad_(True)
    ref = lml.gp_lml_batched(types.cpu(), p_ref, ln_ref, x.cpu(), ym.cpu(),
                             mask.cpu())
    ref.sum().backward()
    torch.testing.assert_close(out.detach().cpu(), ref.detach(),
                               rtol=VAL_RTOL, atol=VAL_ATOL)
    torch.testing.assert_close(p.grad.cpu(), p_ref.grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    torch.testing.assert_close(ln.grad.cpu(), ln_ref.grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def _weekly_model(device, P=8, n_train=24):
    """A depth-3 ensemble reweighted on 24 weeks of a log series, on
    ``device`` (the same seed on both devices gives the same particles)."""
    import datetime as dt

    from nowcastautogp_tpu_torch.models.config import GPConfig
    from nowcastautogp_tpu_torch.models.gp_model import GPModel

    n = n_train + 2 + 3
    dates = [dt.date(2022, 1, 3) + dt.timedelta(weeks=i) for i in range(n)]
    t = np.arange(n)
    y = np.log(800 * np.exp(0.6 * np.sin(2 * np.pi * t / 26 + 1.0)
                            + 0.12 * np.random.default_rng(0)
                            .standard_normal(n)))
    model = GPModel(dates[:n_train], y[:n_train], n_particles=P,
                    config=GPConfig(max_depth=3), seed=5, device=device)
    model.reweight_to(n_train)
    draws = y[n_train:n_train + 2] + np.random.default_rng(1).normal(
        0.0, 0.05, (3, 2))
    return model, dates, draws


def _cpu_copy(model):
    """The model's state on the CPU (its torch generator restarted there:
    the card's generator state does not load into a CPU generator)."""
    from nowcastautogp_tpu_torch.models.gp_model import GPModel

    d = model.to_dict()
    d["device"] = "cpu"
    d["generator_state"] = torch.Generator().get_state().numpy()
    return GPModel(d)


@pytest.mark.parametrize("kw", [
    dict(n_hmc=1, ess_threshold=0.5), dict(n_mcmc=1, n_hmc=1),
    dict(forecast_n_hmc=1), dict(n_hmc=1, serial=True)],
    ids=["n_hmc", "n_mcmc", "forecast_n_hmc", "serial"])
def test_nowcast_branches_on_the_card(dev, kw):
    """Each refresh branch runs on the card through K1/K2, gives finite
    draws of the contract's shape, repeats itself and leaves the base model
    unchanged; the batched branch's reweight LMLs equal the CPU plain
    version's on the same state."""
    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch import nowcast

    kw = dict(kw)
    serial = kw.pop("serial", False)
    model, dates, draws = _weekly_model(dev)
    ncs = ngp.create_nowcast_data(list(draws), dates[24:26])
    if serial:
        ncs = ncs[:2] + ngp.create_nowcast_data([draws[2][:1]], dates[24:25])
    f_dates = dates[26:]
    before = model.to_dict()
    recorded = []
    guard = nowcast._reweight_delta

    def recording(old, new):
        recorded.append((old, new))
        return guard(old, new)

    nowcast._reweight_delta = recording
    try:
        megalml.reset_launch_counts()
        out = ngp.forecast_with_nowcasts(model, ncs, f_dates, 4, **kw)
        assert megalml.K1_LAUNCHES > 0 and megalml.K2_LAUNCHES > 0
        again = ngp.forecast_with_nowcasts(model, ncs, f_dates, 4, **kw)
        cpu_model = _cpu_copy(model)
        ngp.forecast_with_nowcasts(cpu_model, ncs, f_dates, 4, **kw)
    finally:
        nowcast._reweight_delta = guard
    assert out.shape == (3, 12) and np.all(np.isfinite(out))
    np.testing.assert_array_equal(out, again)
    after = model.to_dict()
    for key in ("node_types", "params", "log_noise", "lml", "log_weight",
                "hmc_eps_scale", "generator_state"):
        assert np.array_equal(before[key], after[key]), key
    if not serial:
        (old_k, new_k), _, (old_p, new_p) = recorded
        np.testing.assert_allclose(old_k, old_p, rtol=VAL_RTOL, atol=VAL_ATOL)
        np.testing.assert_allclose(new_k, new_p, rtol=VAL_RTOL, atol=VAL_ATOL)


def test_device_engine_on_the_card(dev):
    """Device proposals on CUDA tensors are valid trees, and a tiny fit
    and a rejuvenation sweep under ``engine="device"`` run through K1/K2
    with finite weights."""
    import nowcastautogp_tpu_torch as ngp
    from nowcastautogp_tpu_torch.models import structures_device as sd

    model, dates, _ = _weekly_model(dev, P=16)
    cfg = sd.config_arrays(model.config, dev)
    anc = torch.as_tensor(sd.ancestor_table(model.config.max_nodes),
                          device=dev)
    gen = torch.Generator(dev)
    gen.manual_seed(3)
    types, params = model._types_d(), model._params_d
    for _ in range(20):
        types, params, log_h = sd.device_propose_mixed(types, params, gen,
                                                       cfg, anc)
        assert types.device.type == dev.type and types.dtype == torch.int32
        for t in types.cpu().numpy():
            assert t[0] != st.EMPTY
            for i in range(3):
                if t[i] in (st.PLUS, st.TIMES, st.CP):
                    assert t[2 * i + 1] != st.EMPTY
                    assert t[2 * i + 2] != st.EMPTY
    megalml.reset_launch_counts()
    acc = model.rejuvenate(2, 1, engine="device")
    assert 0.0 <= acc <= 1.0 and megalml.K1_LAUNCHES == 1 + 2 * (1 + 5)
    data = ngp.create_transformed_data(dates[:24], np.exp(np.arange(24) / 10))
    fitted = ngp.make_and_fit_model(
        data, n_particles=8, smc_data_proportion=0.25, n_mcmc=2, n_hmc=1,
        seed=4, config=ngp.GPConfig(max_depth=3), engine="device",
        device=dev)
    assert fitted.n_ingested == 24
    assert np.all(np.isfinite(fitted.log_weight))
    assert torch.isfinite(fitted._lml_d).all()


def test_every_kernel_on_every_card(dev):
    """Each kernel launched on every visible card, under
    ``torch.cuda.device`` as a mesh shard launches, gives cuda:0's bits:
    the kernels with more than 48 KB of dynamic shared memory (K1, K2,
    K3, K6a, K6b, K5's class-31 launch) set its limit on each card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs more than one card")

    def kernels(d):
        with torch.cuda.device(d):
            args = _batch(d, n=160, n_active=150)
            types, params, diagv, mask, x, ym = args
            _, A, _ = _spd(d, 576, 560)
            t5, p5, x5 = _spd(d, 576, 560)[0]
            L, alpha = chol.chol_solve_batched(_spd(d, 160, 150)[1], ym)
            dK = torch.ones((types.shape[0], 576, 576), device=d)
            out = [megalml.megalml_val(*args), *megalml.megalml_vag(*args),
                   chol_mxu.tri_inv(A), megacov.megacov_fwd(t5, p5, x5),
                   megacov.megacov_bwd(t5, p5, x5, dK), L, alpha,
                   chol.tri_inverse(L)]
            torch.cuda.synchronize()
            return [o.cpu() for o in out]

    ref = kernels(torch.device("cuda", 0))
    for i in range(1, torch.cuda.device_count()):
        for g, r in zip(kernels(torch.device("cuda", i)), ref):
            assert torch.equal(g, r), f"cuda:{i}"
