"""Per-file pipeline: track one recording and write its result tables.

Counterpart of :func:`hsip_tpu.pipeline.process_video_file`. The table
writer (:func:`write_position_results`, :func:`_write_ddt_split_tables`),
the exact float64 backend (:func:`_track_video_exact`) and
:func:`_warn_unmatched_calibration` are copies of the JAX package's, so the
tables are byte-identical; the map phase and the device scan run on a
torch ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import open_video
from .kernels.reference import is_empty_frame, subtract_scalar_background
from .track.config import FlameDetectorConfig, VideoSourceConfig
from .track.host_scan import MIN_SIGNAL_FRACTION, NOISE_THRESHOLD_FLOOR, TrackingOutput
from .track.scan import track_video
from .track.tracker import FlameDetector
from .utils.backend import resolve_device
from .video import SpatialCalibration

__all__ = ["process_video_file", "write_position_results", "BACKENDS",
           "RESULT_COLUMNS"]

BACKENDS = ("gpu", "device", "exact")

RESULT_COLUMNS = [
    "#Frame",
    "Time_s",
    "Position_px",
    "Position_m",
    "Vel_Backward1",
    "Vel_Backward2",
    "Vel_Central",
]

_HEADER_LINES = [
    "# Flame Position and Velocity Data",
    "#",
    "# Velocity Extraction Methods:",
    "#   Vel_Backward1: First-order backward difference",
    "#                  v_n = (x_n - x_{n-1}) / dt",
    "#                  Evaluates velocity at current time step",
    "#",
    "#   Vel_Backward2: Second-order backward difference",
    "#                  v_n = (3*x_n - 4*x_{n-1} + x_{n-2}) / (2*dt)",
    "#                  Higher accuracy at current time, requires 3 points",
    "#",
    "#   Vel_Central:   Second-order central difference",
    "#                  v_{n-1} = (x_n - x_{n-2}) / (2*dt)",
    "#                  Most accurate, but evaluates at PRIOR time step",
    "#",
]



def write_position_results(data: List[Tuple], filepath, label: str = "") -> Path:
    """Write a results table: documented header + space-delimited rows.

    ``data`` rows are (frame, time_s, pos_px, pos_m, v1, v2, vc); velocity
    entries may be None (written as empty fields).
    """
    filepath = Path(filepath)
    with open(filepath, "w") as f:
        for line in _HEADER_LINES:
            f.write(line + "\n")
        f.write(" ".join(RESULT_COLUMNS) + "\n")
        for f_idx, t_s, pixel_pos, p_m, v1, v2, vc in data:
            row = [
                str(f_idx),
                f"{t_s:.9f}",
                str(pixel_pos),
                f"{p_m:.9f}",
                f"{v1:.3f}" if v1 is not None else "",
                f"{v2:.3f}" if v2 is not None else "",
                f"{vc:.3f}" if vc is not None else "",
            ]
            f.write(" ".join(row) + "\n")
    if label:
        print(f"  {label}: {filepath} ({len(data)} points)")
    return filepath


def _write_ddt_split_tables(
    output: TrackingOutput, output_dir: Path, stem: str, verbose: bool = True
) -> dict:
    """All / pre-DDT / post-DDT tables for one video's tracking output."""
    merged = output.merged_rows()
    all_data = [(f, t, px, m, v1, v2, vc) for f, t, px, m, v1, v2, vc, _ in merged]
    pre = [(f, t, px, m, v1, v2, vc) for f, t, px, m, v1, v2, vc, p in merged if not p]
    post = [(f, t, px, m, v1, v2, vc) for f, t, px, m, v1, v2, vc, p in merged if p]

    paths = {}
    paths["all"] = write_position_results(
        all_data, output_dir / f"{stem}-flame-position.txt",
        "All results" if verbose else "",
    )
    if pre:
        paths["pre_ddt"] = write_position_results(
            pre, output_dir / f"{stem}-flame-position-pre-DDT.txt",
            "Pre-DDT" if verbose else "",
        )
    if post:
        paths["post_ddt"] = write_position_results(
            post, output_dir / f"{stem}-flame-position-post-DDT.txt",
            "Post-DDT" if verbose else "",
        )
    return paths



def process_video_file(
    cihx_file,
    config: VideoSourceConfig,
    detector_config: Optional[FlameDetectorConfig] = None,
    backend: str = "gpu",
    verbose: bool = True,
    write_outputs: bool = True,
    save_images: Optional[bool] = None,
    write_tables: bool = True,
    device=None,
) -> TrackingOutput:
    """Process one recording: track the flame front and write result tables.

    ``backend``:
      * 'gpu'    — map phase on ``device``, then the float64 host scan
                   (the default; serves figures directly).
      * 'device' — map phase AND tracking scan on ``device``; profiles never
                   leave it. Figure requests are served by a host-scan
                   replay (row-identical by the backend parity contract).
      * 'exact'  — frame-at-a-time float64 host detector (the anchor; needs
                   no device).

    ``device`` is a torch device; ``None`` means ``cuda``, and then 'gpu'
    and 'device' raise ``RuntimeError`` when CUDA is unavailable. The CPU
    runs only when named (``device="cpu"``).
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"Unknown backend: {backend!r} (expected 'gpu', 'device' or 'exact')"
        )
    dev = resolve_device(device) if backend != "exact" else None
    cihx_file = Path(cihx_file)
    detector_config = detector_config or FlameDetectorConfig()
    file_calibration, file_position_offset = config.get_calibration_for_file(
        cihx_file.name
    )
    _warn_unmatched_calibration(config, cihx_file.name)

    if verbose:
        print(f"\nLoading: {cihx_file.name}")
        print(
            f"  Using calibration: {file_calibration} m/pixel, "
            f"offset: {file_position_offset} m"
        )

    video = open_video(
        str(cihx_file),
        trigger_frame=config.trigger_frame,
        calibration=SpatialCalibration(scale=file_calibration, units="m"),
    )
    try:
        if verbose:
            d = video.describe()
            print(f"  Frames: {d['frames']}")
            print(f"  Frame rate: {d['frame_rate']} fps")
            print(f"  Frame shape: ({d['height']}, {d['width']})")
            print(f"  Duration: {d['duration_s']:.6f} s")
            if "cihx" in d:
                cihx = d["cihx"]
                print("  CIHX Timing (parsed from XML):")
                print(f"    Recording datetime: {cihx['recording_datetime']}")
                print(f"    Record rate: {cihx['record_rate']} fps")
                print(f"    Start frame: {cihx['start_frame']}")
                print(f"    Skip frame: {cihx['skip_frame']}")

        background_scalar = float(np.max(video[0]))
        if verbose:
            print(f"  Background scalar: {background_scalar}")

        output_dir = Path(config.output_dir) if config.output_dir else None
        frames_output_dir = None
        do_images = config.save_frame_images if save_images is None else save_images
        if write_outputs and output_dir is not None:
            output_dir.mkdir(parents=True, exist_ok=True)
            if do_images or config.save_stacked_sequences:
                frames_output_dir = output_dir / f"{cihx_file.stem}-frames"
                frames_output_dir.mkdir(parents=True, exist_ok=True)

        if (write_outputs and frames_output_dir is not None
                and config.save_stacked_sequences):
            from . import viz

            total = len(video)
            n_display = min(15, total)
            step = max(1, total // n_display)
            display_frames = list(range(0, total, step))[:n_display]
            viz.generate_stacked_sequence(
                video, display_frames, background_scalar,
                frames_output_dir / f"{cihx_file.stem}-stacked-sequence.png",
                title=cihx_file.stem, show_frame_diff=True, figsize_width=12.0,
            )
            viz.generate_stacked_sequence_single_column(
                video, display_frames, background_scalar,
                frames_output_dir / f"{cihx_file.stem}-stacked-single.png",
                use_frame_diff=False, title=cihx_file.stem, figsize_width=8.0,
            )

        on_result = None
        viz_tasks = []
        if do_images and frames_output_dir is not None and write_outputs:
            _task_fields = (
                "frame_idx", "time_s", "pos_min_gradient", "pos_rightmost_sobel",
                "pos_spline_predicted", "search_bounds", "final_position",
                "prior_frame_idx",
            )

            def on_result(result, tracker):  # noqa: ANN001
                viz_tasks.append({k: getattr(result, k) for k in _task_fields})

        progress = None
        if verbose and len(video) > 4096:
            def progress(staged, total):  # noqa: ANN001
                print(f"  Staged {staged}/{total} frames...")

        common = dict(
            calibration_m_per_px=file_calibration,
            position_offset_m=file_position_offset,
            skip_frames=config.skip_frames,
            use_absolute_time=config.use_absolute_time,
            background_scalar=background_scalar,
            detection_method=config.detection_method,
            use_frame_diff=config.use_frame_diff,
            device=dev,
        )
        viz_tracker = None  # tracker whose history feeds the figures
        if backend == "exact":
            output = _track_video_exact(
                video, detector_config, file_calibration, file_position_offset,
                config, background_scalar, on_result=on_result,
                progress=(
                    (lambda done, total:
                     print(f"  Processed {done}/{total} frames..."))
                    if verbose else None
                ),
            )
        elif backend == "device":
            output = track_video(video, detector_config, scan="device",
                                 progress=progress, **common)
            if on_result is not None:
                # The device scan emits only positions, so figures come
                # from a host-scan replay (row-identical by contract).
                replay = track_video(video, detector_config, scan="host",
                                     on_result=on_result, **common)
                viz_tracker = replay.tracker
        else:
            output = track_video(video, detector_config, scan="host",
                                 on_result=on_result, progress=progress, **common)

        if verbose:
            print(f"  Skipped {output.empty_frame_count} empty/noise-only frames")
            if output.break_reason == "exit":
                print(f"  Wave exited domain at frame {output.break_frame} (not recorded)")
            elif output.break_reason == "velocity_drop":
                print(f"  Velocity drop detected at frame {output.break_frame} "
                      f"(not recorded)")
            if output.tracker.ddt_detected:
                print(f"  *** DDT DETECTED at frame {output.tracker.ddt_frame} ***")

        if viz_tasks:
            from . import viz

            paths = viz.render_diagnostics_parallel(
                str(cihx_file),
                viz_tasks,
                (viz_tracker or output.tracker).position_history,
                video.frame_rate,
                file_calibration,
                background_scalar,
                frames_output_dir,
                config.name,
                detector_config,
                style=config.figure_style,
            )
            if verbose:
                print(f"  Frame images: {len(paths)} -> {frames_output_dir}")

        if write_outputs and write_tables and output_dir is not None \
                and output.rows:
            _write_ddt_split_tables(output, output_dir, cihx_file.stem, verbose)
            if verbose:
                print("\nResults summary:")
                print(f"  Total detections: {len(output.rows)}")
        return output
    finally:
        video.close()


def _track_video_exact(
    video,
    detector_config: FlameDetectorConfig,
    calibration: float,
    position_offset: float,
    config: VideoSourceConfig,
    background_scalar: float,
    on_result=None,
    progress=None,
) -> TrackingOutput:
    """Bit-exact anchor: the reference's serial frame loop, float64 host ops.

    Loop semantics parity: ``scripts/process_videos.py:1441-1527``
    (including its per-50-frame ``progress`` cadence, ``:1524-1527``).
    """
    detector = FlameDetector(
        detector_config, video.frame_rate, calibration, keep_results=False,
        detection_method=config.detection_method,
        use_frame_diff=config.use_frame_diff,
    )
    time_fn = video.get_absolute_time if config.use_absolute_time else video.get_time
    skip = set(config.skip_frames)

    rows: List[Tuple] = []
    empty_count = 0
    break_frame = None
    break_reason = None
    noise_thresh = max(NOISE_THRESHOLD_FLOOR, background_scalar * 0.5)

    for frame_idx in range(len(video)):
        if frame_idx in skip:
            continue
        if progress is not None and frame_idx and frame_idx % 50 == 0:
            progress(frame_idx, len(video))
        frame = video[frame_idx]
        time_s = time_fn(frame_idx)
        frame_subtracted = subtract_scalar_background(frame, background_scalar)

        if is_empty_frame(frame_subtracted, noise_thresh, MIN_SIGNAL_FRACTION):
            empty_count += 1
            detector.update_prior_frame(frame_subtracted, frame_idx)
            continue

        result = detector.detect(frame, frame_idx, background_scalar)
        if on_result is not None:
            on_result(result, detector.tracker)

        flame_position = result.final_position
        velocity = detector.last_velocity

        if (
            flame_position is not None
            and flame_position >= video.width - detector_config.exit_margin_px
        ):
            detector.clear_last_central_difference()
            break_frame, break_reason = frame_idx, "exit"
            break

        prev_v1, _latest = detector.tracker.last_two_v1()
        if velocity is not None and prev_v1 is not None and prev_v1 > 100:
            if (prev_v1 - velocity) / prev_v1 > 0.5:
                detector.clear_last_central_difference()
                break_frame, break_reason = frame_idx, "velocity_drop"
                break

        if flame_position is not None:
            pos_m = flame_position * calibration + position_offset
            is_post = detector.ddt_detected and frame_idx >= detector.ddt_frame
            rows.append((frame_idx, time_s, flame_position, pos_m, is_post))

    return TrackingOutput(
        rows=rows,
        tracker=detector.tracker,
        empty_frame_count=empty_count,
        break_frame=break_frame,
        break_reason=break_reason,
        total_frames=len(video),
    )


def _warn_unmatched_calibration(config, filename: str) -> None:
    """Warn when file_calibrations exist but none matches this recording.

    Almost always a config mistake (e.g. an "A:B" range pattern that
    compares the LAST filename integer and never matches): say so instead
    of silently producing tables in the wrong units.
    """
    if config.file_calibrations and not config.has_calibration_for_file(
        filename
    ):
        cal, off = config.get_calibration_for_file(filename)
        print(
            f"Warning: no file_calibration entry matches {filename}; "
            f"using source default ({cal} m/px, offset {off} m)"
        )
