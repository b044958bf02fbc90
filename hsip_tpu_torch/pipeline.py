"""Per-file pipeline: track one recording and write its result tables.

Counterpart of :func:`hsip_tpu.pipeline.process_video_file`. The table
writer, the exact float64 backend and the figure renderer are reused from
:mod:`hsip_tpu` by import; the map phase and the device scan run on a
torch ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from hsip_tpu import open_video
from hsip_tpu.pipeline import (
    _track_video_exact,
    _warn_unmatched_calibration,
    _write_ddt_split_tables,
)
from hsip_tpu.track.config import FlameDetectorConfig, VideoSourceConfig
from hsip_tpu.track.scan import TrackingOutput
from hsip_tpu.video import SpatialCalibration

from .track.scan import track_video
from .utils.backend import resolve_device

__all__ = ["process_video_file", "BACKENDS"]

BACKENDS = ("gpu", "device", "exact")


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
            from hsip_tpu import viz

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
            from hsip_tpu import viz

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
