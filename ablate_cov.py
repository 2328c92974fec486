#!/usr/bin/env python3
"""Where K7F/K7B's time goes: throwaway builds of ``csrc/cov.cu``, timed on
one NVIDIA card.

    python3 ablate_cov.py [--parent DIR]

Each variant is this checkout's ``csrc/cov.cu`` and its headers
(``covtile.cuh``, which holds the kernels, and ``heapwalk.cuh``) with one
design piece taken out or changed by a text substitution (asserted to
apply), built by its own ``nvcc -Xptxas -v`` into ``_build/ablate/`` and
loaded with ctypes.  K7F and K7B are timed by the device's clock
(``chip_smoke._time_ms``) at P = 200 on chip_smoke's K7 timing population,
at the "pallas" path's shapes.  ``perclass`` and ``switched`` (K7B's
two launch plans) also at (512, 512) and, on a fitted-like population
(``chip_smoke._population_of``, the "pallas" weekly fit's classes), at
that fit's capacities 32 ... 160 and at 192 ... 512, where K7B's host
time per call is also read: the wall-clock of 100 ctypes calls queued back
to back, the median of five bursts (``_enqueue_us``).  The variants:

  full      the kernels as they are
  hoist     the walk's node loads free to be hoisted out of the element loop
  noskip    empty slots inside a tree's class walked like any other
  regacc    every class's K7B accumulators in registers
  fwd40     K7F held to 40 registers (six blocks an SM instead of four)
  bwd85     K7B's register launch held to 85 registers (three blocks)
  const     the walk replaced by a constant (indexing, loads, stores and
            K7B's reduction alone)
  perclass  the VJP as one launch per heap class whatever the grid
  switched  the VJP as one class-switched launch for classes up to 15
            (register accumulators) and one for 31/63 (shared-memory
            ones) whatever the grid
  classC    every tree walked as heap class C (C = 1, 3, 7, 15, 31), right
            or not: the cost of a walk C slots long, and ptxas's registers
            for that class's body alone

``--parent DIR`` also times the kernels of an earlier checkout DIR with the
pre-redesign layout (no ``sym`` argument, 2,048-element chunks): as they
are, with heaps truncated to N = 1, 3, 7, 15 and 31 slots, with the walk a
constant, with K7B held to 128 registers and with empty slots skipped.
Prints one JSON object, then the ``nvidia-smi`` name/power line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "nowcastautogp_tpu_torch" / "_build" / "ablate"

_FRESH = 'asm volatile("mov.b32 %0, 0;" : "=r"(zero));'
_ELEM = "cov_elem<NC, true>(fresh_nodes(nd), xr[r], xc[c])"
_TILE = "covtile.cuh"
_SWEEP = "walk_bwd<NC, true>(fresh_nodes(nd), xr[r], xc[c], w, acc);"
_FWD_BOUNDS = "__launch_bounds__(THREADS, 4)\ncov_fwd_kernel("
_BWD_BOUNDS = "__launch_bounds__(THREADS, 2)\ncov_bwd_kernel("

# the VJP's launch plan forced: one launch per heap class, or the two
# class-switched launches, whatever the grid
_PLAN = "constexpr long CLASS_LAUNCH_BLOCKS = "
_PLAN_NOW = re.search(re.escape(_PLAN) + r"\w+;", (
    ROOT / "nowcastautogp_tpu_torch" / "csrc" / _TILE).read_text()).group(0)
PER_CLASS = [(_TILE, _PLAN_NOW, _PLAN + "0;")]
SWITCHED = [(_TILE, _PLAN_NOW, _PLAN + "1L << 40;")]
VARIANTS = {
    "full": [],
    "hoist": [(_TILE, _FRESH, "zero = 0;")],
    "noskip": [(_TILE, "cov_elem<NC, true>", "cov_elem<NC, false>"),
               (_TILE, "walk_bwd<NC, true>", "walk_bwd<NC, false>")],
    "regacc": [(_TILE, "REG_CLASS_MAX = 15;", "REG_CLASS_MAX = 63;")],
    "fwd40": [(_TILE, _FWD_BOUNDS, _FWD_BOUNDS.replace("4)", "6)"))],
    "bwd85": [(_TILE, _BWD_BOUNDS,
               _BWD_BOUNDS.replace("2)", "(HI > REG_CLASS_MAX ? 2 : 3))"))],
    "const": [(_TILE, _ELEM, "xr[r] * xc[c] + nd[0].c0"),
              (_TILE, _SWEEP, "acc[0][0] += w * xr[r] * xc[c];")],
    "perclass": PER_CLASS,
    "switched": SWITCHED,
    **{f"class{c}": [
        (_TILE, "switch (heap_class(nd, N)) {", f"switch ({c}) {{"),
        (_TILE, "const int cls = tree_class<N>(types, p);",
         f"const int cls = {c};")]
       for c in (1, 3, 7, 15, 31)},
}

# the pre-redesign kernels (one chunked kernel per N), for --parent
_CASES = "    case 7:  return launch_{0}<7>("
PARENT_VARIANTS = {
    "base": [],
    "const": [("cov.cu", "Kp[e] = cov_elem<N>(nd, a[e / m], b[e % m]);",
               "Kp[e] = a[e / m] * b[e % m] + nd[0].c0;"),
              ("cov.cu", "walk_bwd<N>(nd, a[e / m], b[e % m], Dp[e], acc);",
               "acc[0][0] += Dp[e] * a[e / m] * b[e % m];")],
    "lb2": [("cov.cu", "__global__ void __launch_bounds__(THREADS)\n"
             "cov_bwd_kernel(", "__global__ void __launch_bounds__(THREADS, 2)"
             "\ncov_bwd_kernel(")],
    "skip": [("heapwalk.cuh", "    const int t = nd[k].type;\n    float val",
              "    const int t = nd[k].type;\n"
              "    if (t == EMPTY) { v[k] = 0.0f; continue; }\n    float val"),
             ("heapwalk.cuh", "    const int t = nd[k].type;\n"
              "    const float g = dv[k];",
              "    const int t = nd[k].type;\n    if (t == EMPTY) continue;\n"
              "    const float g = dv[k];")],
}


def _parent_cases(src):
    """The parent's C switches, with N = 1 and 3 instantiated too."""
    for kind in ("fwd", "bwd"):
        head = _CASES.format(kind)
        assert head in src, f"parent cov.cu has no {head.strip()!r}"
        args = src.split(head)[1].split("\n")[0]
        extra = "".join(f"    case {k}:  return launch_{kind}<{k}>({args}\n"
                        for k in (1, 3))
        src = src.replace(head, extra + head, 1)
    return src


def _write_variant(name, csrc, subs, parent, main):
    """``main`` and every header of ``csrc`` with ``subs`` applied (each
    replaces every occurrence), written to ``_build/ablate/name/``."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    files = {f.name: f.read_text()
             for f in [csrc / main, *sorted(csrc.glob("*.cuh"))]}
    if parent:
        files[main] = parent(files[main])
    for f, old, new in subs:
        if old not in files[f]:
            raise cs.SmokeFailure(f"{name}: {old!r} not in {f}")
        files[f] = files[f].replace(old, new)
    for f, text in files.items():
        (d / f).write_text(text)
    return d / main


def build(variants, main="cov.cu", signatures=None):
    """{name: (csrc dir, substitutions, parent hook or None)} -> {name:
    (lib, ptxas)}: ``main`` built with its headers, one nvcc each, all at
    once; ``signatures(lib, name)`` sets the entry points' argtypes."""
    from nowcastautogp_tpu_torch.ops import cudalib

    nvcc = cudalib._nvcc()
    procs = {}
    for name, (csrc, subs, parent) in variants.items():
        src = _write_variant(name, csrc, subs, parent, main)
        procs[name] = subprocess.Popen(
            [nvcc, *cudalib._ARCH, "-Xptxas", "-v", "-Xcompiler", "-fPIC",
             "-shared", "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for p in procs.values():  # unread pipes could block them
                p.kill()
                p.wait()
            raise cs.SmokeFailure(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str((OUT / name / main).with_suffix(".so")))
        (signatures or _cov_signatures)(lib, variants[name][2] is not None)
        libs[name] = (lib, _registers(out))
    return libs


def _cov_signatures(lib, parent):
    ints = 6 if parent else 7   # the parent's layout had no sym argument
    lib.cov_fwd.argtypes = [ctypes.c_int] * ints + [ctypes.c_void_p] * 6
    lib.cov_bwd.argtypes = [ctypes.c_int] * ints + [ctypes.c_void_p] * 8


def _registers(log):
    """{kernel instantiation: [registers, spill store bytes]} from ptxas."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"entry function '\S*?((?:mega)?cov_(?:fwd|bwd)_kernel"
                      r"|megalml_(?:val|vag|bwd)_kernel)I(\S*?)E+v", line)
        if m:  # cov_bwd_kernelILi31ELi5ELi0ELb1EEEv... -> <31,5,0,1>
            args = (m.group(2).replace("ELi", ",").replace("ELb", ",")
                    .replace("Li", ""))
            name = f"{m.group(1)}<{args}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = [int(m.group(1)), spill]
            name = None
    return out


def _enqueue_us(fn, calls=100, bursts=5):
    """Host microseconds per call of ``fn`` (one C call, its launches
    queued): the median over ``bursts`` of ``calls`` calls made back to
    back after a synchronisation, few enough that the launch queue never
    fills and the host never waits for the card."""
    import time

    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def main():
    import torch

    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    csrc = ROOT / "nowcastautogp_tpu_torch" / "csrc"
    todo = {k: (csrc, subs, None) for k, subs in VARIANTS.items()}
    if parent is not None:
        todo.update({f"parent_{k}": (parent / "nowcastautogp_tpu_torch" /
                                     "csrc", subs, _parent_cases)
                     for k, subs in PARENT_VARIANTS.items()})
    libs = build(todo)

    dev = "cuda"
    types, params = cs._population(200, 160, seed=11)[:2]
    x = torch.linspace(0, 1, 160, device=dev)
    copy = x.clone()
    xs = 1.0 + torch.arange(1, 9, device=dev) / 159.0
    wide = torch.linspace(0, 1, 512, device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    dK = {n: torch.randn((200, n, n), generator=gen, device=dev)
          for n in (160, 512)}
    dK[(160, 8)] = torch.randn((200, 160, 8), generator=gen, device=dev)

    def launcher(lib, kind, t, p, a, b, sym, old):
        P, N = t.shape
        n, m = a.shape[-1], b.shape[-1]
        head = [N, P, n, m, 0, 0] + ([] if old else [int(sym)])

        def stream():  # the capture stream while a graph is captured
            return torch.cuda.current_stream().cuda_stream

        if kind == "fwd":
            K = torch.empty((P, n, m), device=dev)
            return lambda: lib.cov_fwd(*head, t.data_ptr(), p.data_ptr(),
                                       a.data_ptr(), b.data_ptr(),
                                       K.data_ptr(), stream())
        g = dK[n] if n == m else dK[(n, m)]
        dp = torch.empty((P, N, 3), device=dev)
        part = torch.empty((P, 2048, 3 * N), device=dev)  # >= tiles, chunks
        return lambda: lib.cov_bwd(*head, t.data_ptr(), p.data_ptr(),
                                   a.data_ptr(), b.data_ptr(), g.data_ptr(),
                                   dp.data_ptr(), part.data_ptr(), stream())

    shapes = {"fwd_n160": ("fwd", x, x, True),
              "fwd_n160_general": ("fwd", x, copy, False),
              "fwd_n160_m8": ("fwd", x, xs, False),
              "fwd_n8": ("fwd", xs, xs, True),
              "fwd_n512": ("fwd", wide, wide, True),
              "bwd_n160": ("bwd", x, x, True),
              "bwd_n160_general": ("bwd", x, copy, False),
              "bwd_n160_m8": ("bwd", x, xs, False),
              "bwd_n512": ("bwd", wide, wide, True)}
    main_shapes = ("fwd_n160", "bwd_n160")
    fitted = cs._population_of(cs.FITTED_WEEKLY_CLASSES, 160, seed=5)[:2]
    more = (32, 64, 96, 128, 192, 256, 320, 384)
    caps = {n: torch.linspace(0, 1, n, device=dev) for n in more}
    caps.update({160: x, 512: wide})
    dK.update({n: torch.randn((200, n, n), generator=gen, device=dev)
               for n in more})
    res = {"card": smi, "classes": cs._class_histogram(types),
           "classes_fitted": cs._class_histogram(fitted[0]),
           "ms": {}, "registers": {}, "host_us": {}}
    for name, (lib, regs) in libs.items():
        res["registers"][name] = regs
        old = name.startswith("parent_")
        keep = shapes if name in ("full", "parent_base") else {
            k: shapes[k] for k in main_shapes}
        if name in ("perclass", "switched"):
            keep = {**keep, "bwd_n512": shapes["bwd_n512"]}
        runs = [(tag, types, params) for tag in keep]
        if name in ("parent_base", "parent_skip"):  # heaps cut to N slots
            runs += [(f"{tag}_N{N}", types[:, :N].contiguous(),
                      params[:, :N].contiguous())
                     for N in (1, 3, 7, 15, 31) for tag in main_shapes]
        for tag, t, p in runs:
            kind, a, b, sym = shapes[tag.split("_N")[0]]
            ms, spread = cs._time_ms(launcher(lib, kind, t, p, a, b, sym, old))
            res["ms"][f"{name}:{tag}"] = [ms, spread]
        if name in ("perclass", "switched"):  # K7B's two plans
            for n, a in sorted(caps.items()):
                fn = launcher(lib, "bwd", *fitted, a, a, True, False)
                res["ms"][f"{name}:bwd_n{n}_fitted"] = list(cs._time_ms(fn))
                res["host_us"][f"{name}:bwd_n{n}_fitted"] = _enqueue_us(fn)
        torch.cuda.synchronize()
    print(json.dumps(res))
    print(smi)


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeFailure as e:
        cs.log(f"ablate_cov: FAILED: {e}")
        sys.exit(1)
