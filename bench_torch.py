#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: MRAW frames/s on one card for the
end-to-end decode+track pipeline.

Prints ONE JSON line under 2000 characters whose last keys are::

    "metric", "value", "unit", "vs_baseline", "device"

Pipeline measured: open a synthetic CIHX/MRAW recording from disk, gather
the packed 12-bit band rows and count the above-noise pixels on the host,
decode and run the band kernel on the card, run the tracking scan (default:
the scan kernel on the card; ``--scan host`` for the float64 host scan,
single mode only), produce the result rows. ``hsip_tpu_torch`` only: the
port's ``track_video`` per recording and ``track_collection_device`` over a
library, on an explicit ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain PyTorch versions and is labelled so).

``--mode both`` (the default) measures one library of ``--videos``
recordings (one payload, hard-linked) two ways in interleaved,
order-alternating repeats: the per-file loop (one recording at a time, the
reference's execution shape) and library mode. The rows of both must be
equal, video for video, before any time is reported; if they differ, the
error object is printed and the exit code is 1. The headline ``value`` is
the library's median frames/s; ``vs_baseline`` divides it by the host
baseline: the reference-equivalent serial scipy chain (full-frame
grey_opening → gaussian_filter → sobel → gradient per frame) timed on this
machine's CPU (``scipy_serial_fps``).

Per-repeat samples, both modes' ``StageTimes`` and the ``--videos16``
amortization point go to the file named by ``--samples-out`` (default
``hsip-output/bench-torch-samples.json`` beside this script); the JSON line
names it.

Usage: python3 bench_torch.py [--device cuda|cuda:N|cpu] [--frames N]
    [--height H] [--width W] [--videos V] [--repeat R] [--mode both|single|library]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from hsip_tpu_torch.utils.profiling import device_info, launched_by, sync

REPO = Path(__file__).resolve().parent
METRIC = "mraw_frames_per_sec_per_chip_decode_track"
# bench.py's calibration and offset, on both routes (per file and library).
CALIBRATION_M_PER_PX = 0.000833333
POSITION_OFFSET_M = 1.0159
BASELINE_LABEL = "host: the serial scipy chain on this machine's CPU"
# Interleaved pairs of the --videos16 amortization point.
V16_PAIRS = 2

# Stamped when main() starts; the repeats' deadline guard reads it.
_START = time.monotonic()


def build_recording(tmpdir: Path, n_frames: int, height: int, width: int):
    """bench.py's recording: seed 42, the front crossing ~77% of the image."""
    from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording

    flame = FlameSpec(
        x0=30.0,
        v0_px=width / (1.3 * n_frames),
        accel_px=0.0,
        ignition_frame=2,
        seed=42,
    )
    frames, _ = synthesize_flame_video(n_frames, height=height, width=width, flame=flame)
    spec = CihxSpec(
        width=width, height=height, total_frames=n_frames,
        record_rate=100_000, bit_depth=12,
    )
    return write_recording(tmpdir, "bench-run-1-001", frames, spec=spec)


def build_library(tmpdir: Path, n_videos: int, source, dirname: str = "lib") -> Path:
    """``n_videos`` recordings under ``bench-run-NN-001`` names: ``source``'s
    header copied, its payload hard-linked, so every video is the same
    decode+track work at no extra build or disk cost."""
    lib = tmpdir / dirname
    lib.mkdir(exist_ok=True)
    source = Path(source)
    payload = source.with_suffix(".mraw")
    for v in range(n_videos):
        cihx = lib / f"bench-run-{v + 1:02d}-001.cihx"
        mraw = cihx.with_suffix(".mraw")
        if cihx != source:
            shutil.copyfile(source, cihx)
        if mraw != payload:
            if mraw.exists():
                mraw.unlink()
            os.link(payload, mraw)
    return lib


def run_file_pipeline(meta_path, config, device, scan="device", stage_times=None):
    """One recording through ``track_video`` on ``device``."""
    from hsip_tpu_torch import open_video
    from hsip_tpu_torch.track.scan import track_video

    with open_video(str(meta_path)) as video:
        out = track_video(
            video, config,
            calibration_m_per_px=CALIBRATION_M_PER_PX,
            position_offset_m=POSITION_OFFSET_M,
            scan=scan,
            stage_times=stage_times,
            device=device,
        )
    sync(device)
    return out


def run_per_file_pipeline(lib, config, device, scan="device", stage_times=None):
    """The per-file loop over the library's recordings in name order; the
    same bytes as library mode. Returns (outputs, summed scan seconds)."""
    outs = []
    scan_s = 0.0
    for cihx in sorted(Path(lib).glob("*.cihx")):
        out = run_file_pipeline(cihx, config, device, scan, stage_times=stage_times)
        scan_s += out.phase_timings["scan_s"]
        outs.append(out)
    return outs, scan_s


def library_source_config():
    """The library's source: bench.py's calibration for every recording, so
    its rows are comparable with the per-file loop's."""
    from hsip_tpu_torch.track.config import VideoSourceConfig

    return VideoSourceConfig(
        name="bench", calibration=CALIBRATION_M_PER_PX,
        position_offset=POSITION_OFFSET_M, save_frame_images=False,
        save_stacked_sequences=False,
    )


def run_collection_pipeline(video_dir, config, device, stage_times=None):
    """Library mode: ``track_collection_device`` over every recording of
    ``video_dir`` (name order). Returns (outputs, group paths)."""
    from hsip_tpu_torch import open_collection
    from hsip_tpu_torch.track import batch
    from hsip_tpu_torch.track.batch import track_collection_device

    with open_collection(str(video_dir)) as coll:
        outs = track_collection_device(
            coll, config, source_config=library_source_config(),
            stage_times=stage_times, device=device,
        )
    sync(device)
    return outs, list(batch.LAST_GROUP_PATHS)


class RowsDiffer(RuntimeError):
    """The per-file loop and library mode disagree on a video's rows."""


def check_rows(per_file_outs, library_outs, names) -> None:
    """Raise :class:`RowsDiffer` unless both routes gave every video the
    same rows."""
    if len(per_file_outs) != len(library_outs) or len(library_outs) != len(names):
        raise RowsDiffer(f"per-file loop gave {len(per_file_outs)} outputs, library "
                         f"{len(library_outs)}, over {len(names)} recordings")
    for name, a, b in zip(names, per_file_outs, library_outs):
        if a.rows != b.rows:
            raise RowsDiffer(f"rows of {name} differ between the per-file loop "
                             f"({len(a.rows)} rows) and library mode ({len(b.rows)} rows)")


def time_scipy_baseline(meta_path, config, n_sample: int) -> float:
    """Per-frame seconds of the reference-equivalent serial scipy chain,
    on the host CPU."""
    import scipy.ndimage as ndi

    from hsip_tpu_torch import open_video

    with open_video(str(meta_path)) as video:
        frames = video.read_batch(0, n_sample + 1).astype(np.float64)
    n_sample = min(n_sample, len(frames) - 1)  # short --frames runs
    if n_sample < 1:
        raise ValueError(
            "scipy baseline needs >= 2 frames (frame differencing); "
            f"recording has {len(frames)}"
        )
    bg = float(frames[0].max())
    sub = np.maximum(frames - bg, 0.0)
    k, sigma = config.morphology_kernel_size, config.gaussian_sigma

    best = float("inf")
    for _ in range(3):  # best-of to damp host noise
        start = time.perf_counter()
        for i in range(1, n_sample + 1):
            diff = sub[i] - sub[i - 1]
            diff[diff < config.frame_diff_threshold] = 0
            opened = ndi.grey_opening(diff, size=(k, k))
            blurred = ndi.gaussian_filter(opened, sigma=sigma)
            sob = ndi.sobel(blurred, axis=1)
            grad = np.gradient(blurred, axis=1)
            c = blurred.shape[0] // 2
            _ = sob[c], grad[c]
            if np.min(grad[c]) < -config.min_gradient_strength:
                _ = np.argmin(grad[c])
        best = min(best, time.perf_counter() - start)
    return best / n_sample


def time_device_compute(meta_path, config, device, repeats: int = 3):
    """Device-compute-only seconds of one recording, on inputs already on
    ``device``: the packed band's decode and the band kernel
    (``packed_band_profiles``), then the scan kernel with the fetch of the
    positions and the float64 tables (``run_tracking_scan_device``). No
    disk read, host gather or host-to-device copy is inside the timed
    region; each timed run ends in ``torch.cuda.synchronize()``.

    Returns ``{"map_s", "scan_s", "tables_s", "frames", "launches"}``
    (best of ``repeats`` each; ``tables_s``, the part of the best scan run
    spent on the float64 tables on the host, is inside ``scan_s``;
    ``launches`` of one map and one scan run), or None when the recording
    has no packed band path.
    """
    from hsip_tpu_torch import open_video
    from hsip_tpu_torch.kernels.preprocess import band_margin, reflect_indices
    from hsip_tpu_torch.kernels.unpack import packed_band_profiles
    from hsip_tpu_torch.track.host_scan import NOISE_THRESHOLD_FLOOR, FrameProfiles
    from hsip_tpu_torch.track.scan import run_tracking_scan_device
    from hsip_tpu_torch.utils import StageTimes

    with open_video(str(meta_path)) as video:
        n = len(video)
        h, w = video.frame_shape
        bg = float(np.max(video[0]))
        _read_packed, read_band, count_fn, depth = video.staging_paths()
        if read_band is None or count_fn is None:
            return None
        margin = band_margin(config.morphology_kernel_size, config.gaussian_sigma)
        rows = reflect_indices(h // 2, margin, h)
        host = np.array(read_band(0, n, rows))
        noise_threshold = max(NOISE_THRESHOLD_FLOOR, bg * 0.5)
        counts = np.asarray(count_fn(0, n, bg, noise_threshold))
        frame_rate = video.frame_rate

    band_bytes = torch.from_numpy(host).to(device)
    prior = torch.arange(-1, n - 1, dtype=torch.int32, device=device)
    bg32 = float(np.float32(bg))
    thr32 = float(np.float32(config.frame_diff_threshold))

    def run_map():
        outs = packed_band_profiles(
            band_bytes, bg32, prior, thr32,
            morphology_kernel_size=config.morphology_kernel_size,
            gaussian_sigma=config.gaussian_sigma,
            bit_depth=depth,
        )
        sync(device)
        return outs

    def best_of(fn):
        """(best seconds, that run's StageTimes) of ``fn(stage_times)``."""
        best, best_st = float("inf"), None
        for _ in range(repeats):
            st = StageTimes()
            t0 = time.perf_counter()
            fn(st)
            dt = time.perf_counter() - t0
            if dt < best:
                best, best_st = dt, st
        return best, best_st

    (sob, grad, intens, rawc), map_launches = launched_by(run_map)  # warm-up
    best_map, _ = best_of(lambda st: run_map())

    has_prior = np.ones(n, dtype=bool)
    has_prior[0] = False
    profiles = FrameProfiles(
        frame_indices=np.arange(n, dtype=np.int64),
        sobel_lines=sob, gradient_lines=grad, intensity_lines=intens,
        raw_center_lines=rawc, signal_counts=counts.astype(np.int64),
        has_prior=has_prior, width=w, total_pixels=h * w,
    )

    def run_scan(stage_times=None):
        # Ends in the fetch of the positions (a synchronizing copy) and the
        # float64 tables on the host; both belong to the scan stage, and
        # the tables' share is kept apart (its "tables" stage).
        out = run_tracking_scan_device(
            profiles, config, frame_rate=frame_rate,
            calibration_m_per_px=CALIBRATION_M_PER_PX,
            position_offset_m=POSITION_OFFSET_M,
            stage_times=stage_times,
        )
        sync(device)
        return out

    _, scan_launches = launched_by(run_scan)  # warm-up
    best_scan, scan_st = best_of(run_scan)
    return {"map_s": best_map, "scan_s": best_scan,
            "tables_s": scan_st.as_dict(9).get("tables", 0.0), "frames": n,
            "launches": [a + b for a, b in zip(map_launches, scan_launches)]}


def _repeats_deadline_note(rep: int, total: int, elapsed: float,
                           est_next: float, time_budget: float):
    """Main-repeat deadline guard: the truncation note, or None to keep
    measuring.

    Stop BETWEEN pairs when the projected next pair (its cost bounded by
    the slowest pair so far) would pass 72% of ``--time-budget``, leaving
    the tail for the scipy baseline and teardown (the V=16 point's own 55%
    guard then skips it). Never truncate below the 4 pairs the
    pairwise-ratio IQR needs; pairs stay complete, so the pairwise
    statistic is unaffected. The same decision as bench.py's guard.
    """
    if rep < 4:
        return None
    if elapsed + est_next <= 0.72 * time_budget:
        return None
    return (
        f"stopped after {rep} of {total} pairs: {elapsed:.0f}s elapsed "
        f"+ est. next pair {est_next:.0f}s would pass 72% of the "
        f"{time_budget:.0f}s time budget; pairs stay complete so the "
        "pairwise statistic is unaffected"
    )


def run_bench(args, config, device: torch.device):
    """Measure the requested mode(s) on ``device``.

    Returns ``(line, detail, fps, baseline_fps)``: the keys of the JSON
    line before its headline keys, what goes only to the samples file, the
    headline frames/s and the host baseline's frames/s.
    """
    from hsip_tpu_torch.utils import StageTimes

    line: dict = {}
    detail: dict = {}
    run_single = args.mode in ("both", "single")
    run_library = args.mode in ("both", "library")
    # In --mode both the single side is the per-file loop over the library
    # (the same bytes as library mode in every repeat); --mode single times
    # one recording.
    per_file_loop = args.mode == "both"
    single_route = "per_file" if per_file_loop else "single"
    single_key = f"{single_route}_s"
    single_fps = library_fps = None
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="hsip-bench-torch-") as tmp:
        tmpdir = Path(tmp)
        meta = build_recording(tmpdir, args.frames, args.height, args.width)
        lib = names = None
        if run_library:
            lib = build_library(tmpdir, args.videos, meta)
            names = [p.name for p in sorted(lib.glob("*.cihx"))]
        total_frames = args.frames * args.videos

        def single_run(stage_times=None):
            if per_file_loop:
                return run_per_file_pipeline(lib, config, device, args.scan,
                                             stage_times=stage_times)
            out = run_file_pipeline(meta, config, device, args.scan, stage_times=stage_times)
            return [out], out.phase_timings["scan_s"]

        # Warm-ups (first launches, pinned pool, page cache), each counted
        # for its launches; the rows of both routes must agree before any
        # repeat is timed.
        outs_single = outs_library = None
        if run_single:
            (outs_single, _), launches[single_route] = launched_by(single_run)
        if run_library:
            (outs_library, paths), launches["library"] = launched_by(
                lambda: run_collection_pipeline(lib, config, device))
            line["library_group_paths"] = paths
        if per_file_loop:
            check_rows(outs_single, outs_library, names)

        # Interleaved repeats, the order flipping every repeat, so neither
        # mode always inherits the state the other leaves behind.
        best_s, best_st_s, best_scan_s = float("inf"), None, None
        best_l, best_st_l = float("inf"), None
        samples: dict = {single_key: [], "library_s": []}
        for rep in range(args.repeat):
            pair_costs = [sum(t) for t in zip(*(v for v in samples.values() if v))]
            note = _repeats_deadline_note(
                rep, args.repeat, time.monotonic() - _START,
                max(pair_costs, default=0.0), args.time_budget,
            )
            if note is not None:
                line["repeats_truncated"] = note
                break
            legs = (["s"] if run_single else []) + (["l"] if run_library else [])
            if rep % 2:
                legs.reverse()
            for leg in legs:
                st = StageTimes()
                t0 = time.perf_counter()
                if leg == "s":
                    outs_single, scan_s = single_run(stage_times=st)
                else:
                    outs_library, _ = run_collection_pipeline(lib, config, device,
                                                              stage_times=st)
                dt = time.perf_counter() - t0
                if leg == "s":
                    samples[single_key].append(dt)
                    if dt < best_s:
                        # Stages and phase timings of the same repeat.
                        best_s, best_st_s, best_scan_s = dt, st, scan_s
                else:
                    samples["library_s"].append(dt)
                    if dt < best_l:
                        best_l, best_st_l = dt, st
            if per_file_loop:
                check_rows(outs_single, outs_library, names)
        if per_file_loop:
            line["rows_checked"] = (f"per-file loop == library on all {len(names)} "
                                    f"videos, warm-up and every repeat")
        line["repeats"] = len(samples[single_key] or samples["library_s"])
        detail["samples"] = {k: v for k, v in samples.items() if v}
        detail["stages_note"] = (
            "stages are from each mode's best repeat; per-stage host "
            "wall-clock; stages of overlapping threads are summed and may "
            "exceed end_to_end_s"
        )
        # Central statistic: the median of the interleaved repeats; the
        # pairwise ratio shares each repeat's conditions between the modes.
        line["statistic"] = ("median of interleaved order-alternating repeats; "
                             "*_fps_best = best-of")
        med_s = statistics.median(samples[single_key]) if run_single else None
        med_l = statistics.median(samples["library_s"]) if run_library else None
        if run_single and run_library:
            pair_ratios = sorted(
                pf / lb for pf, lb in zip(samples[single_key], samples["library_s"]))
            line["library_speedup_pairwise_median"] = round(
                statistics.median(pair_ratios), 3)
            detail["library_speedup_pairs"] = pair_ratios
            if len(pair_ratios) >= 4:
                q = statistics.quantiles(pair_ratios, n=4)
                line["library_speedup_pairs_iqr"] = [round(q[0], 3), round(q[2], 3)]

        if run_single:
            single_frames = total_frames if per_file_loop else args.frames
            single_fps = single_frames / med_s
            line["single_mode"] = (f"per-file loop over the {args.videos} recordings"
                                   if per_file_loop else "one recording")
            line["single_video_fps"] = round(single_fps, 1)
            line["single_fps_best"] = round(single_frames / best_s, 1)
            line["single_median_s"] = round(med_s, 6)
            detail["single_end_to_end_s"] = best_s
            detail["single_stages"] = best_st_s.as_dict(6)
            detail["single_stages"]["scan_phase"] = round(best_scan_s, 6)
            print(f"single[{'per-file' if per_file_loop else 'one-video'}]: "
                  f"frames={single_frames} {args.height}x{args.width} "
                  f"best_s={best_s:.4f} median_s={med_s:.4f} "
                  f"rows={len(outs_single[0].rows)} stages={detail['single_stages']}",
                  file=sys.stderr)
            dev = time_device_compute(meta, config, device)
            if dev is not None:
                dev_s = dev["map_s"] + dev["scan_s"]
                line["device_compute_fps"] = round(dev["frames"] / dev_s, 1)
                # "scan" holds "scan_host_tables": the float64 tables on
                # the host, not the card's work.
                line["device_compute_ms"] = {
                    "map": round(dev["map_s"] * 1e3, 4),
                    "scan": round(dev["scan_s"] * 1e3, 4),
                    "scan_host_tables": round(dev["tables_s"] * 1e3, 4)}
                launches["device_compute"] = dev["launches"]
                print(f"device-compute-only: {dev_s * 1e3:.3f} ms for {dev['frames']} "
                      f"frames ({line['device_compute_fps']:.0f} fps)", file=sys.stderr)
        if run_library:
            library_fps = total_frames / med_l
            line["library_fps"] = round(library_fps, 1)
            line["library_fps_best"] = round(total_frames / best_l, 1)
            line["library_median_s"] = round(med_l, 6)
            line["library_videos"] = args.videos
            detail["library_payload"] = "hard-linked (shared page cache)"
            detail["library_end_to_end_s"] = best_l
            detail["library_stages"] = best_st_l.as_dict(6)
            # The host side of staging: the fused native gather+count pass.
            host_s = detail["library_stages"].get("read_gather", 0.0)
            if host_s > 0:
                line["host_staging_fps"] = round(total_frames / host_s, 1)
            print(f"library: videos={args.videos} frames={total_frames} "
                  f"best_s={best_l:.4f} median_s={med_l:.4f} "
                  f"rows={len(outs_library[0].rows)} stages={detail['library_stages']}",
                  file=sys.stderr)

        # Amortization point: the same pairing at --videos16 recordings.
        if per_file_loop and args.videos16 > args.videos:
            elapsed = time.monotonic() - _START
            if elapsed > 0.55 * args.time_budget:
                detail["library_v16"] = {
                    "skipped": f"main repeats took {elapsed:.0f}s (>55% of the "
                               f"{args.time_budget:.0f}s time budget)"}
            else:
                detail["library_v16"] = _v16_point(args, config, device, tmpdir, meta)
                line["library_v16_speedup_pairwise_median"] = \
                    detail["library_v16"]["speedup_pairwise_median"]

        baseline_fps = 1.0 / time_scipy_baseline(meta, config, args.baseline_sample)
    line["launches"] = launches
    line["scipy_serial_fps"] = round(baseline_fps, 1)
    line["baseline"] = BASELINE_LABEL
    fps = library_fps if library_fps is not None else single_fps
    return line, detail, fps, baseline_fps


def _v16_point(args, config, device, tmpdir, meta) -> dict:
    """Per-file loop against library mode at ``--videos16`` recordings,
    ``V16_PAIRS`` interleaved pairs after one warm-up of each; rows
    checked on every pair."""
    lib16 = build_library(tmpdir, args.videos16, meta, dirname="lib16")
    names16 = [p.name for p in sorted(lib16.glob("*.cihx"))]
    total16 = args.frames * args.videos16
    v16: dict = {"per_file_s": [], "library_s": []}
    run_per_file_pipeline(lib16, config, device, args.scan)
    run_collection_pipeline(lib16, config, device)
    for rep in range(V16_PAIRS):
        outs = {}
        for leg in (["s", "l"] if rep % 2 == 0 else ["l", "s"]):
            t0 = time.perf_counter()
            if leg == "s":
                outs[leg], _ = run_per_file_pipeline(lib16, config, device, args.scan)
                v16["per_file_s"].append(time.perf_counter() - t0)
            else:
                outs[leg], _ = run_collection_pipeline(lib16, config, device)
                v16["library_s"].append(time.perf_counter() - t0)
        check_rows(outs["s"], outs["l"], names16)
    pairs16 = sorted(pf / lb for pf, lb in zip(v16["per_file_s"], v16["library_s"]))
    point = {
        "videos": args.videos16,
        "library_fps": round(total16 / statistics.median(v16["library_s"]), 1),
        "samples": v16,
        "speedup_pairs": pairs16,
        "speedup_pairwise_median": round(statistics.median(pairs16), 3),
    }
    print(f"library_v16: videos={args.videos16} frames={total16} {point}", file=sys.stderr)
    return point


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N, or cpu (the "
                        "kernels' plain PyTorch versions, labelled 'cpu')")
    parser.add_argument("--frames", type=int, default=2048)
    parser.add_argument("--height", type=int, default=128)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument(
        "--repeat", type=int, default=12,
        help="interleaved repeats; the headline is the median; 12 pairs "
        "give the pairwise ratio's IQR usable resolution. Guarded by "
        "--time-budget: the pairs truncate between complete repeats "
        "(never below 4)",
    )
    parser.add_argument(
        "--videos16", type=int, default=16,
        help="video count of the amortization point (library against the "
        "per-file loop at a larger V, 2 interleaved pairs; skipped when the "
        "main repeats took more than 55%% of --time-budget; 0 or <= --videos "
        "disables)",
    )
    parser.add_argument("--baseline-sample", type=int, default=48)
    parser.add_argument(
        "--scan", choices=("host", "device"), default="device",
        help="tracking scan: 'device' (the scan kernel on the card) or "
        "'host' (the float64 host scan, the 'gpu' backend's route; "
        "single mode only)",
    )
    parser.add_argument(
        "--mode", choices=("both", "single", "library"), default="both",
        help="'both' times the per-file loop against library mode over the "
        "same --videos recordings; the headline is library mode's when it runs",
    )
    parser.add_argument("--videos", type=int, default=8,
                        help="library's video count (each --frames long)")
    parser.add_argument(
        "--time-budget", type=float, default=1500.0,
        help="seconds this process may spend; the repeats and the V=16 "
        "point are guarded against it",
    )
    parser.add_argument(
        "--samples-out", default=str(REPO / "hsip-output" / "bench-torch-samples.json"),
        help="file for the per-repeat samples, stages and the V=16 point",
    )
    return parser


def _error_json(msg: str) -> str:
    return json.dumps({"error": msg, "metric": METRIC, "value": None,
                       "unit": "frames/s", "vs_baseline": None, "device": None})


def main(argv=None) -> int:
    global _START
    _START = time.monotonic()
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.scan == "host" and args.mode != "single":
        parser.error("--scan host applies to single-video mode only "
                     "(library mode always runs the device scan)")
    from hsip_tpu_torch.kernels import _build
    from hsip_tpu_torch.track import FlameDetectorConfig
    from hsip_tpu_torch.utils import resolve_device

    try:
        device = resolve_device(args.device)
        info = device_info(device)
        build_s = None
        if device.type == "cuda":
            # Outside every timed window: nvcc on a fresh checkout.
            t0 = time.perf_counter()
            _build.load_kernels()
            build_s = round(time.perf_counter() - t0, 3)
        line, detail, fps, baseline_fps = run_bench(args, FlameDetectorConfig(), device)
    except Exception as exc:  # noqa: BLE001 -- the contract is one JSON line
        traceback.print_exc(file=sys.stderr)
        print(_error_json(f"{type(exc).__name__}: {exc}"))
        return 1
    samples_out = Path(args.samples_out)
    result = {
        **line,
        "build_s": build_s,
        "shape": f"{args.videos}x{args.frames}x{args.height}x{args.width} 12-bit",
        "samples_file": str(samples_out),
        "metric": METRIC,
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
        "device": info,
    }
    samples_out.parent.mkdir(parents=True, exist_ok=True)
    samples_out.write_text(json.dumps({**result, **detail}, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
