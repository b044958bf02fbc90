#!/usr/bin/env python3
"""Render the port's fused library pipeline timeline (``hsip_tpu_torch``).

The fused library path (``hsip_tpu_torch/track/fused.py``) splits a
library into G groups: group g is gathered into pinned memory, copied on
the copy stream and ENQUEUED on the compute stream before group g+1's
gather begins, and no result is fetched until every group is enqueued, so
group g's device program runs under group g+1's host gather. This tool
reads that overlap off the per-group timestamps the fused path records
(``fused._LAST_PIPELINE_TRACE``):

    python tools/pipeline_trace_torch.py [--videos 8] [--frames 2048]
        [--groups 1 4] [--device cuda|cpu] [--width 1024] [--height 128] [--trace]

The defaults are the library bench_torch.py times: 8 recordings of 2048
frames of 128x1024, 12-bit.

For each requested G it prints one row per group (slot, gather window,
dispatch time, the moment the group's copies had completed, when its
results landed) and the summary:

    overlap_s   host gather time spent while >=1 earlier program was in
                flight (the pipelining; 0 by construction at G=1)
    tail_s      wall from the LAST dispatch to the last result: the device
                time left exposed

``--trace`` adds one run per G under ``torch.profiler``: the card's busy
time, idle share and top kernels. The rows are checked identical across
every swept G (exit 1 if not). The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def build_library(directory: Path, videos: int, frames: int, height: int, width: int):
    """``videos`` recordings of one payload (pipeline_trace.py's flame,
    seed 7) under ``trace-run-NN-001`` names."""
    from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording

    flame = FlameSpec(x0=25.0, v0_px=width / (1.3 * frames), accel_px=0.0,
                      ignition_frame=2, seed=7)
    shot, _ = synthesize_flame_video(frames, height=height, width=width, flame=flame)
    spec = CihxSpec(width=width, height=height, total_frames=frames,
                    record_rate=100_000, bit_depth=12)
    src = Path(write_recording(directory, "trace-run-01-001", shot, spec=spec))
    for v in range(1, videos):
        cihx = directory / f"trace-run-{v + 1:02d}-001.cihx"
        cihx.write_bytes(src.read_bytes())
        os.link(src.with_suffix(".mraw"), cihx.with_suffix(".mraw"))


def print_timeline(g: int, wall: float, repeats: int, trace) -> dict:
    """The per-group table of one run; returns its summary numbers."""
    t_base = trace[0]["gather_start_t"]
    print(f"\n=== G={g}  end_to_end={wall:.4f}s  (best of {repeats}) ===")
    print(f"{'grp':>3} {'slot':>4} {'gather':>15} {'dispatch':>9} "
          f"{'inputs_rel':>10} {'finals':>8}")
    overlap = 0.0
    for i, tr in enumerate(trace):
        gs = tr["gather_start_t"] - t_base
        ge = tr["gather_end_t"] - t_base
        dp = tr["dispatch_t"] - t_base
        ir = tr["inputs_ready_t"] - t_base
        fr = tr.get("finals_ready_t", float("nan")) - t_base
        print(f"{i:>3} {tr['slot']:>4} {gs:>7.4f}-{ge:>7.4f} {dp:>9.4f} "
              f"{ir:>10.4f} {fr:>8.4f}")
        if i > 0:
            # Gather time spent while an earlier program was already
            # enqueued (and not yet fetched): the pipelined overlap.
            prev_dispatch = trace[i - 1]["dispatch_t"] - t_base
            overlap += max(0.0, ge - max(gs, prev_dispatch))
    tail = trace[-1].get("finals_ready_t", t_base) - trace[-1]["dispatch_t"]
    gather_wall = sum(t["gather_end_t"] - t["gather_start_t"] for t in trace)
    print(f"  gather_wall={gather_wall:.4f}s  overlap_s={overlap:.4f}  tail_s={tail:.4f}")
    return {"end_to_end_s": wall, "groups": len(trace), "gather_wall_s": gather_wall,
            "overlap_s": overlap, "tail_s": tail,
            "launches": [sum(t["launches"][k] for t in trace) for k in (0, 1)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--groups", type=int, nargs="*", default=[1, 4],
                    help="G values to sweep (HSIP_FUSED_GROUPS per run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N, or cpu")
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs per G; the reported run is the fastest")
    ap.add_argument("--trace", action="store_true",
                    help="one more run per G under torch.profiler: the card's "
                    "busy time, idle share and top kernels")
    args = ap.parse_args(argv)

    from hsip_tpu_torch import open_collection
    from hsip_tpu_torch.kernels import _build
    from hsip_tpu_torch.track import FlameDetectorConfig
    from hsip_tpu_torch.track import fused
    from hsip_tpu_torch.utils import resolve_device
    from hsip_tpu_torch.utils.profiling import device_info, device_time, sync

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"pipeline_trace_torch: {exc}", file=sys.stderr)
        return 2
    summary = {"device": device_info(device), "per_group": {},
               "shape": [args.videos, args.frames, args.height, args.width]}
    if device.type == "cuda":
        _build.load_kernels()
    config = FlameDetectorConfig()
    rows_by_g = {}
    old_groups = os.environ.get("HSIP_FUSED_GROUPS")
    with tempfile.TemporaryDirectory(prefix="hsip-pipeline-trace-") as tmp:
        d = Path(tmp)
        print(f"building {args.videos} x {args.frames}-frame "
              f"{args.height}x{args.width} recordings ...", file=sys.stderr)
        build_library(d, args.videos, args.frames, args.height, args.width)

        with open_collection(str(d)) as coll:
            videos = list(coll)
            w = videos[0].frame_shape[1]

            def run():
                outs = fused.track_uniform_videos_fused(videos, w, config, None, True,
                                                        device=device)
                sync(device)
                return outs

            try:
                for g in args.groups:
                    os.environ["HSIP_FUSED_GROUPS"] = str(g)
                    best = None
                    for _ in range(args.repeats):
                        t0 = time.perf_counter()
                        outs = run()
                        wall = time.perf_counter() - t0
                        if outs is None:
                            print("fused path declined the group; nothing to trace",
                                  file=sys.stderr)
                            return 2
                        if best is None or wall < best[0]:
                            best = (wall, [dict(t) for t in fused._LAST_PIPELINE_TRACE])
                    rows_by_g[g] = [[(r[0], r[2]) for r in o.rows] for o in outs]
                    entry = print_timeline(g, best[0], args.repeats, best[1])
                    if args.trace:
                        entry["trace"] = device_time(run, device)
                        print(f"  device busy {entry['trace']['device_busy_s']:.4f}s of "
                              f"{entry['trace']['wall_s']:.4f}s, idle share "
                              f"{entry['trace']['idle_share']:.4f}")
                    summary["per_group"][str(g)] = entry
            except RuntimeError as exc:
                if "no device events" not in str(exc):
                    raise
                print(f"pipeline_trace_torch: --trace: {exc}", file=sys.stderr)
                return 1
            finally:
                if old_groups is None:
                    os.environ.pop("HSIP_FUSED_GROUPS", None)
                else:
                    os.environ["HSIP_FUSED_GROUPS"] = old_groups

    g0 = args.groups[0]
    for g in args.groups[1:]:
        if rows_by_g[g] != rows_by_g[g0]:
            print(f"\nFAIL: rows differ between G={g0} and G={g}", file=sys.stderr)
            return 1
    print(f"\nrows identical across G={args.groups} "
          f"({sum(len(r) for r in rows_by_g[g0])} rows/video-set)")
    summary["rows_identical"] = True
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
