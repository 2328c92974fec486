"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` source is compiled for sm_90a by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, bound with ``ctypes``.  The library lands
in ``_build/`` beside the package (listed in ``.gitignore``), named by a hash
over every source and header, so an edit to any of them rebuilds it at first
use and an unchanged tree reuses it.

Each C entry point launches on the calling thread's current CUDA device and
sets its kernels' dynamic shared-memory limit before every launch (the
attribute is per device), so one process may launch on several cards
(``parallel/sharding.py``).  ``LaunchCounter`` keeps the wrappers' launch
counts exact when host threads launch at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build_library", "library", "raise_on", "LaunchCounter"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
_LIB = None
_LIB_LOCK = threading.Lock()

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# C entry points: (argument types), all returning a cudaError_t as int
_SIGNATURES = {
    "megalml_val": [_I32, _I32, _I32] + [_PTR] * 10,
    "megalml_vag": [_I32, _I32, _I32] + [_PTR] * 15,
    "megalml_tiles": [_I32],
    "megacov_fwd": [_I32, _I32, _I32] + [_PTR] * 5,
    "megacov_bwd": [_I32, _I32, _I32] + [_PTR] * 7,
    "megacov_tiles": [_I32],
    "tri_inv": [_I32, _I32] + [_PTR] * 5,
    "chol_solve": [_I32, _I32] + [_PTR] * 6,
    "chol_tri_inverse": [_I32, _I32] + [_PTR] * 4,
    "cov_fwd": [_I32] * 7 + [_PTR] * 6,
    "cov_bwd": [_I32] * 7 + [_PTR] * 8,
    "cov_tiles": [_I32] * 3,
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"),
                 CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _tag() -> str:
    h = hashlib.sha256(" ".join(_ARCH).encode())
    for path in sum(_sources(), []):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless a library built from the same sources
    exists.  Returns (library path, compiler log); ``verbose`` asks ptxas
    for its register and spill report (and rebuilds to get it)."""
    lib = _BUILD_DIR / f"libngp_{_tag()}.so"
    if lib.exists() and not verbose:
        return lib, ""
    _BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    stem = _BUILD_DIR / f"{lib.stem}.{os.getpid()}"
    objs = [Path(f"{stem}.{cu.stem}.o") for cu in cus]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    procs = [subprocess.Popen(
        [nvcc, *_ARCH, *ptxas, "-Xcompiler", "-fPIC", "-c", "-o", str(obj),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cu, obj in zip(cus, objs)]
    logs = []
    for cu, proc in zip(cus, procs):
        out, _ = proc.communicate()
        logs.append(f"== {cu.name}\n{out}")
        if proc.returncode != 0:
            for p in procs:  # unread pipes could block them: stop them
                p.kill()
                p.wait()
            raise RuntimeError(f"nvcc failed on {cu.name} ({proc.returncode}):"
                               f"\n{out}")
    tmp = Path(f"{stem}.tmp")
    link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, lib)
    return lib, "\n".join(logs)


def library():
    """The loaded kernel library (built on first use, by one thread)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I32
            _LIB = lib
    return _LIB


def raise_on(rc: int, which: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{which} launch failed with cudaError_t {rc}")


class LaunchCounter:
    """Launch counts of named kernels, exact when several host threads
    launch at once: each wrapper calls ``bump`` where it launches its
    kernel, and only there.  A module that owns one serves its counts as
    module attributes (``megalml.K1_LAUNCHES``) through ``__getattr__``."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def bump(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def __contains__(self, name: str) -> bool:
        return name in self._counts

    def reset(self) -> None:
        with self._lock:
            for name in self._counts:
                self._counts[name] = 0
