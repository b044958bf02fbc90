#!/usr/bin/env python3
"""Stage-attributed profiling of the port's single-video and library
pipelines (``hsip_tpu_torch``).

Builds (and caches under --cache-dir, default ``hsip-output/stage-cache``
in the repository) bench_torch.py's recording and an N-video library of
hard links, then times both pipeline shapes on --device, best of --repeat,
with :class:`hsip_tpu_torch.utils.StageTimes` attribution. ``--trace`` runs
each mode once more under ``torch.profiler`` (CPU and CUDA activities),
outside the timed runs, and reports for that run the card's busy time (the
union of its kernel and copy intervals), its idle share (1 - busy / wall)
and the five kernels with the most device time; a trace with no device
events fails the tool.

Usage: python tools/stage_profile_torch.py [--frames 2048] [--videos 8]
       [--repeat 3] [--mode both|single|library] [--device cuda|cpu] [--trace]

Prints one JSON report on stdout. The cache survives across runs, so
iterating on staging costs seconds, not the synthesis.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def cached_inputs(root: Path, frames: int, height: int, width: int, videos: int):
    """(recording, library directory) under ``root``, built once."""
    from bench_torch import build_library, build_recording

    cache = root / f"f{frames}-h{height}-w{width}"
    if not cache.exists():
        print(f"synthesizing {frames} frames into {cache} ...", file=sys.stderr)
        tmp = cache.with_name(f"{cache.name}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        build_recording(tmp, frames, height, width)
        os.replace(tmp, cache)  # a cut build never looks complete
    meta = cache / "bench-run-1-001.cihx"
    lib = cache / f"lib{videos}"
    if not (lib / f"bench-run-{videos:02d}-001.cihx").exists():
        build_library(cache, videos, meta, dirname=lib.name)
    return meta, lib


def profile_mode(run, repeat: int, device, trace: bool) -> dict:
    """Warm-up, best of ``repeat`` timed runs of ``run(stage_times)`` (its
    outputs), and with ``trace`` one more run under the profiler."""
    from hsip_tpu_torch.utils import StageTimes
    from hsip_tpu_torch.utils.profiling import device_time, launched_by

    run(None)
    best, best_st, launches = float("inf"), None, None
    for _ in range(repeat):
        st = StageTimes()
        t0 = time.perf_counter()
        outs, launched = launched_by(lambda: run(st))
        dt = time.perf_counter() - t0
        if dt < best:
            best, best_st, launches = dt, st, launched
    report = {"end_to_end_s": best, "rows": len(outs[0].rows),
              "stages": best_st.as_dict(6), "launches": launches}
    if trace:
        report["trace"] = device_time(lambda: run(None), device)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--mode", choices=("both", "single", "library"), default="both")
    ap.add_argument("--cache-dir", default=str(REPO / "hsip-output" / "stage-cache"))
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N, or cpu")
    ap.add_argument("--trace", action="store_true",
                    help="one more run per mode under torch.profiler: the "
                    "card's busy time, idle share and top kernels")
    args = ap.parse_args(argv)

    from bench_torch import run_collection_pipeline, run_file_pipeline
    from hsip_tpu_torch.kernels import _build
    from hsip_tpu_torch.track import FlameDetectorConfig
    from hsip_tpu_torch.utils import resolve_device
    from hsip_tpu_torch.utils.profiling import device_info

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"stage_profile_torch: {exc}", file=sys.stderr)
        return 2
    report = {"device": device_info(device)}
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.load_kernels()
        report["build_s"] = time.perf_counter() - t0
    meta, lib = cached_inputs(Path(args.cache_dir), args.frames, args.height,
                              args.width, args.videos)
    config = FlameDetectorConfig()

    try:
        if args.mode in ("both", "single"):
            report["single"] = profile_mode(
                lambda st: [run_file_pipeline(meta, config, device, stage_times=st)],
                args.repeat, device, args.trace)
            report["single"]["fps"] = args.frames / report["single"]["end_to_end_s"]
        if args.mode in ("both", "library"):
            report["library"] = profile_mode(
                lambda st: run_collection_pipeline(lib, config, device, stage_times=st)[0],
                args.repeat, device, args.trace)
            report["library"]["fps"] = (args.frames * args.videos
                                        / report["library"]["end_to_end_s"])
            report["library"]["videos"] = args.videos
    except RuntimeError as exc:
        if "no device events" not in str(exc):
            raise
        print(f"stage_profile_torch: --trace: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
