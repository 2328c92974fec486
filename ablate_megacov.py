#!/usr/bin/env python3
"""Where K4/K5's time goes: throwaway builds of ``csrc/megacov.cu``, timed
on one NVIDIA card.

    python3 ablate_megacov.py [--parent DIR]

Each variant is this checkout's ``csrc/megacov.cu`` and its headers
(``covtile.cuh``, the kernels it shares with K7F/K7B, and ``heapwalk.cuh``)
with one design choice set or one piece taken out by a text substitution
(asserted to apply), built by its own ``nvcc -Xptxas -v`` into
``_build/ablate/`` (``ablate_cov.build``) and loaded with ctypes.  K4 and K5
are timed by the device's clock (``chip_smoke._time_ms``) at P = 200 and
n = 576, the daily fit's composed step, on three populations: chip_smoke's
K4/K5 timing population (``_population(200, 576, seed=9)``, prior trees,
mostly heap class 1), a weekly-fitted-like one and a daily-fitted-like one
(``chip_smoke._population_of``: prior trees drawn to the heap classes of
a fitted ensemble, 154 / 28 / 5 / 13 of classes 3 / 7 / 15 / 31 for the
"pallas" path's weekly fit, 8 / 192 of classes 15 / 31 for the daily fit
at capacity 576).  All but ``hoist`` and ``const`` are also timed at
n = 2048 on the timing population (the composed path's largest capacity).

  full         the kernels as committed: 32 x 32 tiles, K4 one
               class-switched launch, K5 one launch per heap class
  tile64       64 x 64 tiles
  k5_switched  K5 in two class-switched launches, one for classes up to
               15 and one for 31/63 (register and shared-memory
               accumulators), whatever the grid (``ablate_cov.SWITCHED``)
  k4_grouped   K4 as K5 runs: one launch per heap class
  hoist       the walk's node loads free to be hoisted out of the element
              loop (no ``fresh_nodes``)
  const       the walk replaced by a constant (indexing, loads, stores and
              K5's reduction alone)

``--parent DIR`` also times K4/K5 of an earlier checkout DIR as they are.

Then, on the committed kernels, the composed core's backward cotangent
dA = c/2 (alpha alpha^T - A^-1) at P = 200, n = 576, formed three ways:
in float64 in two passes (``InvCoreFn.backward``), in float64 as
``CholCoreFn`` forms it (five passes), and in float32; each alone and
within the composed core's value + gradient, in turns (each form twice, in
mirrored order).  Prints one JSON object, then the ``nvidia-smi`` name/power line.
"""

from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

import ablate_cov
import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
_MAIN = "megacov.cu"
_TILE = "covtile.cuh"
_ELEM = "cov_elem<NC, true>(fresh_nodes(nd), xr[r], xc[c])"
_SWEEP = "walk_bwd<NC, true>(fresh_nodes(nd), xr[r], xc[c], w, acc);"
_FRESH = 'asm volatile("mov.b32 %0, 0;" : "=r"(zero));'

# K4 as one launch per heap class, the plan K5 runs: a class template on
# the forward kernel, its blocks of other classes exiting first
_FWD_HEAD = ("template <int N>\n__global__ void __launch_bounds__"
             "(THREADS, 4)\ncov_fwd_kernel(")
_FWD_P = "  const int p = blockIdx.y;\n  __shared__ Node nd[N];"
_FWD_SWITCH = "  switch (heap_class(nd, N)) {\n    case 1: fwd_tile"
_FWD_LAUNCH = """  cov_fwd_kernel<N><<<dim3(n_tiles(a.n, a.m, a.sym), a.P), THREADS, 0, s>>>(
      a.n, a.m, a.sym, a.types, a.params, a.x1, a.s1, a.x2, a.s2, K);
  return static_cast<int>(cudaGetLastError());"""
_FWD_CLASSES = """  const dim3 grid(n_tiles(a.n, a.m, a.sym), a.P);
#define CLS_LAUNCH(C)                                                    \\
  if constexpr (C <= N) {                                                \\
    cov_fwd_kernel<N, C><<<grid, THREADS, 0, s>>>(                       \\
        a.n, a.m, a.sym, a.types, a.params, a.x1, a.s1, a.x2, a.s2, K);  \\
    const cudaError_t e = cudaGetLastError();                            \\
    if (e != cudaSuccess) return static_cast<int>(e);                    \\
  }
  CLS_LAUNCH(1) CLS_LAUNCH(3) CLS_LAUNCH(7) CLS_LAUNCH(15) CLS_LAUNCH(31)
  CLS_LAUNCH(63)
  return 0;"""


def variants(csrc):
    """{name: substitutions} against this checkout's ``csrc``."""

    def setting(f, pattern, value):
        found = re.findall(pattern, (csrc / f).read_text())
        if len(found) != 1:
            raise cs.SmokeFailure(f"{pattern!r} matches {found} in {f}")
        return (f, found[0], re.sub(r"= \w+;", f"= {value};", found[0]))

    return {
        "full": [],
        "tile64": [setting(_TILE, r"constexpr int TILE_LG = \d;", 6)],
        "k5_switched": ablate_cov.SWITCHED,
        "k4_grouped": [
            (_TILE, _FWD_HEAD, _FWD_HEAD.replace("<int N>",
                                                 "<int N, int CLS = 0>")),
            (_TILE, _FWD_P, _FWD_P.replace(
                "\n", "\n  if (CLS != 0 && tree_class<N>(types, p) != CLS) "
                "return;\n", 1)),
            (_TILE, _FWD_SWITCH, _FWD_SWITCH.replace(
                "heap_class(nd, N)", "CLS != 0 ? CLS : heap_class(nd, N)")),
            (_TILE, _FWD_LAUNCH, _FWD_CLASSES)],
        "hoist": [(_TILE, _FRESH, "zero = 0;")],
        "const": [(_TILE, _ELEM, "xr[r] * xc[c] + nd[0].c0"),
                  (_TILE, _SWEEP, "acc[0][0] += w * xr[r] * xc[c];")]}


def _signatures(lib, parent):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.megacov_fwd.argtypes = [i32] * 3 + [ptr] * 5
    lib.megacov_bwd.argtypes = [i32] * 3 + [ptr] * 7
    lib.megacov_tiles.argtypes = [i32]


def _against_parent(libs, pop, dK):
    """K4 and K5 of the committed and the parent's build on the same
    operands: K4 bitwise equal?  K5 sums in another order: its largest
    difference beside the largest |dparams|."""
    import torch

    types, params, _, _, x, _ = pop
    (P, N), n = types.shape, x.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    got = {}
    for name in ("full", "parent"):
        lib = libs[name][0]
        K = torch.empty((P, n, n), device=x.device)
        dp = torch.empty((P, N, 3), device=x.device)
        part = torch.empty((P, lib.megacov_tiles(n), 3 * N), device=x.device)
        head = (N, P, n, types.data_ptr(), params.data_ptr(), x.data_ptr())
        rc = (lib.megacov_fwd(*head, K.data_ptr(), stream),
              lib.megacov_bwd(*head, dK.data_ptr(), dp.data_ptr(),
                              part.data_ptr(), stream))
        cs.check(rc == (0, 0), f"{name}: K4/K5 returned {rc}")
        got[name] = K, dp
    (K, g), (K0, g0) = got["full"], got["parent"]
    return {"K4_bitwise": cs._bitwise(K, K0),
            "K4_max_abs_diff": float((K - K0).abs().max()),
            "K5_max_abs_diff": float((g - g0).abs().max()),
            "K5_max_abs": float(g0.abs().max())}


def main():
    import torch

    from nowcastautogp_tpu_torch.ops import lml, megacov

    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = cs.setup()
    csrc = ROOT / "nowcastautogp_tpu_torch" / "csrc"
    todo = {k: (csrc, subs, None) for k, subs in variants(csrc).items()}
    if parent is not None:
        todo["parent"] = (parent / "nowcastautogp_tpu_torch" / "csrc", [],
                          lambda src: src)
    libs = ablate_cov.build(todo, main=_MAIN, signatures=_signatures)

    dev = cs.DEVICE
    pops = {"timing": cs._population(200, 576, seed=9),
            "fitted": cs._population_of(cs.FITTED_WEEKLY_CLASSES, 576, 5),
            "daily": cs._population_of(cs.FITTED_DAILY_CLASSES, 576, 5)}
    wide = cs._population(200, 2048, seed=9)
    gen = torch.Generator(dev).manual_seed(1)
    dK = {n: torch.randn((200, n, n), generator=gen, device=dev)
          for n in (576, 2048)}

    def launcher(lib, kind, types, params, x):
        P, N = types.shape
        n = x.shape[-1]

        def stream():  # the capture stream while a graph is captured
            return torch.cuda.current_stream().cuda_stream

        head = (N, P, n, types.data_ptr(), params.data_ptr(), x.data_ptr())
        if kind == "K4":
            K = torch.empty((P, n, n), device=dev)
            return lambda: lib.megacov_fwd(*head, K.data_ptr(), stream())
        dp = torch.empty((P, N, 3), device=dev)
        part = torch.empty((P, lib.megacov_tiles(n), 3 * N), device=dev)
        return lambda: lib.megacov_bwd(*head, dK[n].data_ptr(), dp.data_ptr(),
                                       part.data_ptr(), stream())

    res = {"card": smi, "classes": {k: cs._class_histogram(v[0])
                                    for k, v in pops.items()},
           "ms": {}, "registers": {}}
    cs.log(f"ablate_megacov: heap classes {res['classes']}")
    for name, (lib, regs) in libs.items():
        res["registers"][name] = regs
        runs = [(f"{k}_n576_{pop}", k, pops[pop]) for pop in pops
                for k in ("K4", "K5")]
        if name in ("full", "tile64", "k5_switched", "k4_grouped",
                    "parent"):
            runs += [(f"{k}_n2048", k, wide) for k in ("K4", "K5")]
        for tag, kind, (types, params, _, _, x, _) in runs:
            small = x.shape[-1] == 576
            ms, spread = cs._time_ms(
                launcher(lib, kind, types, params, x), *((3, 20) if small
                                                         else (1, 5)))
            res["ms"][f"{name}:{tag}"] = [ms, spread]
        torch.cuda.synchronize()
        cs.log(f"ablate_megacov: {name} done")

    if parent is not None:
        res["vs_parent"] = _against_parent(libs, pops["timing"], dK[576])

    # the composed core's cotangent: the committed float64 formation (two
    # passes), CholCoreFn's float64 formation (five) and float32
    types, params, diagv, mask, x, ym = pops["timing"]
    p = params.clone().requires_grad_(True)
    K = megacov.megacov_fwd(types, params, x)
    A = (K * (mask[:, :, None] * mask[:, None, :])
         + torch.diag_embed(diagv)).contiguous()
    Ainv = torch.linalg.inv(A)
    alpha = (Ainv @ ym[..., None])[..., 0]
    c = torch.ones(200, device=dev)

    def f64_five(ctx, c):
        Ainv, alpha = ctx.saved_tensors
        a = alpha.double()
        dA = ((0.5 * c.double())[:, None, None]
              * (a[:, :, None] * a[:, None, :] - Ainv.double()))
        return dA.to(alpha.dtype), -c[:, None] * alpha

    def f32(ctx, c):
        Ainv, alpha = ctx.saved_tensors
        dA = (0.5 * c)[:, None, None] * (alpha[:, :, None] * alpha[:, None, :]
                                         - Ainv)
        return dA, -c[:, None] * alpha

    class Ctx:
        saved_tensors = (Ainv, alpha)

    def composed():
        lml.lml_core_composed(types, p, diagv, mask, x, ym).sum().backward()

    forms = {"f64": lml.InvCoreFn.__dict__["backward"],
             "f64_five": staticmethod(f64_five), "f32": staticmethod(f32)}
    try:
        for tag in ("f64", "f64_five", "f32", "f32", "f64_five", "f64"):
            lml.InvCoreFn.backward = forms[tag]
            for key, fn in ((f"cotangent_{tag}",
                             lambda: lml.InvCoreFn.backward(Ctx, c)),
                            (f"composed_vag_{tag}", composed)):
                res["ms"].setdefault(key, []).append(cs._burst_ms(fn, 1, 5))
    finally:
        lml.InvCoreFn.backward = forms["f64"]
    print(json.dumps(res))
    print(smi)


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeFailure as e:
        cs.log(f"ablate_megacov: FAILED: {e}")
        sys.exit(1)
