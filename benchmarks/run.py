#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its line.

    python3 benchmarks/run.py --workload nova.library --seed 7 \
        --seconds 20 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the harness (``benchmarks/harness``) generates the cell's
recordings from ``--seed``, warms the route up, calls the program's user
entry in a closed loop for ``--seconds``, checks every table the window
wrote against the plain reference (``benchmarks/reference``) and prints
one JSON line: the end-to-end metrics with ``--trace 0``, the per-layer
metrics read from ``torch.profiler`` and the program's ``StageTimes`` with
``--trace 1``.

Exit codes: 0 with a line; 2 without a card (or with fewer than the cell
asks for); 3 when the program cannot be imported; 4 when JAX or the JAX
package was loaded. ``--rehearse`` (never passed by the check) runs a
shrunken cell on the CPU with the kernels' plain versions, to find faults
of paths and shapes without a card; its line names the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="a shrunken cell on the CPU (never a measurement)")
    return p.parse_args(argv)


def _environment():
    """The program's defaults, and every build cache inside the checkout
    at a fixed path."""
    for key in [k for k in os.environ if k.startswith("HSIP_")]:
        del os.environ[key]
    cache = REPO / ".bench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(REPO), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    args = _args(argv)
    _environment()
    from harness.runner import run_cell

    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    rehearse=args.rehearse, t0=T0)


if __name__ == "__main__":
    sys.exit(main())
