"""Run one cell of the benchmark once, on the NVIDIA cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the numbers compared with the reference, each beside its limit,
as the last lines of standard error, and one JSON result as the last line
of standard output.  Exits non-zero, with no result, where torch sees
fewer cards than the cell asks for, or where JAX or the JAX package was
loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with one host thread for every library: the cells are
# host-bound in part, and the card's host is shared.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, compared = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"benchmark: JAX or the JAX package is loaded: {leaked}",
              file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} {c['op']} limit "
              f"{c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
