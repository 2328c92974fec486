"""Port parity: ``utils/flops.py`` (the fit's cost accounting and MFU).

The JAX package asks XLA's cost model for one LML program's cost; the port
counts the algorithm analytically.  With both packages'
``_lml_program_costs`` patched to the same numbers, ``fit_cost_analysis``
must compose them identically (the same capacity segments and call
counts).  The analytic counts are held to their formulas, and ``mfu`` to
its arithmetic on the H100's peaks.
"""

import numpy as np
import pytest

from nowcastautogp_tpu.models.config import GPConfig as JGPConfig
from nowcastautogp_tpu.utils import flops as jflops
from nowcastautogp_tpu_torch.inference.schedule import linear_schedule
from nowcastautogp_tpu_torch.models.config import GPConfig
from nowcastautogp_tpu_torch.utils import flops


def _fake_costs(P, cap, config, *rest):
    return (P * cap * 1.0, P * cap * 3.0, P * cap * 5.0, P * cap * 7.0)


@pytest.mark.parametrize("n_mcmc,n_hmc", [(14, 5), (3, 0)])
def test_fit_cost_analysis_composes_as_jax(monkeypatch, n_mcmc, n_hmc):
    monkeypatch.setattr(jflops, "_lml_program_costs", _fake_costs)
    monkeypatch.setattr(flops, "_lml_program_costs", _fake_costs)
    kw = dict(P=200, schedule=linear_schedule(560, 0.125), cap_full=576,
              n_mcmc=n_mcmc, n_hmc=n_hmc, n_leapfrog=5)
    want = jflops.fit_cost_analysis(config=JGPConfig(max_depth=5), **kw)
    got = flops.fit_cost_analysis(config=GPConfig(max_depth=5), **kw)
    assert got == want


def test_call_counts_are_the_device_engines():
    """The weekly fit's schedule (150 weeks, proportion 0.1; 14 x 5 x 5
    moves) gives the device engine's 3,650 gradient and 10 value calls."""
    counts = flops.fit_call_counts(schedule=linear_schedule(150, 0.1),
                                   cap_full=160, n_mcmc=14, n_hmc=5,
                                   n_leapfrog=5)
    assert [c[0] for c in counts] == sorted(c[0] for c in counts)
    assert sum(c[1] for c in counts) == 10
    assert sum(c[2] for c in counts) == 3650


def test_mfu_arithmetic():
    out = flops.mfu(2.5e12, 4.0)
    assert out["fit_tflops"] == 2.5
    assert out["achieved_tflops_per_s"] == 0.625
    assert out["mfu_vs_h100_fp32_peak"] == round(0.625e12 / 67e12, 5)
    assert out["mfu_vs_h100_fp64_tensor_peak"] == round(
        0.625e12 / flops.PEAK_FP64_TENSOR, 5)
    assert not any("v5e" in k or "bf16" in k for k in out)


def test_program_costs_follow_the_kernel_counts():
    """Up to 512 a value is K2's work and a gradient K1's; above it the
    composed core adds n^3 / 3 for X^T X to K4 + K3's work (and K5 for
    the gradient).  Costs scale with P; the default trees are a fixed
    sample of the prior."""
    cfg = GPConfig(max_depth=3)
    types = np.zeros((4, 7), np.int32)
    types[:, 0], types[:, 1], types[:, 2] = 6, 2, 4   # PLUS(SE, PERIODIC)
    c = flops.kernel_costs(types, 160)
    f, g, fb, gb = flops._lml_program_costs(4, 160, cfg, types)
    assert (f, g, fb, gb) == (c["K2"][1], c["K1"][1], c["K2"][0],
                              c["K1"][0])
    assert flops._lml_program_costs(8, 160, cfg, types)[0] == 2 * f
    n = 2208
    c = flops.kernel_costs(types, n)
    f, g, _, _ = flops._lml_program_costs(4, n, cfg, types)
    assert f > c["K4"][1] + c["K3"][1] + 4 * n ** 3 / 3
    assert g - f > c["K5"][1]
    assert c["K3"][1] == 4 * 2 * n ** 3 / 3
    walk = (flops.ELEM_OPS + flops.FWD_OPS[types].sum(1)).sum()
    assert c["K4"][1] == n * (n + 1) / 2 * walk
    assert flops._lml_program_costs(4, 96, cfg) == \
        flops._lml_program_costs(4, 96, cfg)
    ms, by = flops.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
