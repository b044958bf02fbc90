#!/usr/bin/env python3
"""The control of the check: the plain reference put in the program's
place and computed in bfloat16, at a cell's own size, on given seeds.

    python3 benchmarks/control.py --workload nova.library --seeds 1 2 3

For each seed it generates the cell's recordings, computes the reference's
tables in float64 and in bfloat16 (the band chain rounded to bfloat16
after every operation; the configuration states float32 profiles), and
prints one JSON line: the numbers the check compares, as the bfloat16
tables read against the float64 ones, each recording once (a window
repeats the same recordings, so its shares are those of one pass), each
beside the configuration's limit, and ``correct`` by the same rule as a
run of the benchmark (:func:`harness.check.is_correct`). The benchmark's
runs do not run it; its readings set the upper end of each limit. Runs on
the CPU; needs no card.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=None,
                   help="shrink the recordings (tests only)")
    p.add_argument("--recordings", type=int, default=None,
                   help="fewer recordings (tests only)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from gen import plan_library, write_library
    from harness.cell import load_cell
    from harness.check import checks_of, compare_calls, is_correct, reference_for
    from harness.runner import _pool

    cell = load_cell(args.workload)
    src, det = cell.config["source"], cell.config["detector"]
    workers = max(1, min(8, os.cpu_count() or 1))
    for seed in args.seeds:
        plans = plan_library(cell.traffic, cell.config, seed,
                             frames=args.frames, recordings=args.recordings)
        work = Path(tempfile.mkdtemp(prefix="hsip-control-"))
        try:
            t0 = time.perf_counter()
            with _pool(workers) as pool:
                paths = write_library(str(work), plans, pool)
                exact = reference_for(paths, src, det, pool)
                low = reference_for(paths, src, det, pool, precision="bfloat16")
            calls = [{"index": 0, "out_dir": None,
                      "recordings": list(range(len(paths)))}]
            verdict = compare_calls(calls, paths, exact,
                                    lambda _, stem, kind: low[
                                        [Path(q).stem for q in paths].index(stem)
                                    ].get(kind))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        limits = cell.config["limits"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": "bfloat16",
            "correct": is_correct(verdict, limits),
            "rows_expected": verdict["rows_expected"],
            "rows_off": verdict["rows_off"], "answers": verdict["answers"],
            "seconds": time.perf_counter() - t0,
            "checks": checks_of(verdict, limits),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
