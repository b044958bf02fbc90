"""Pipeline orchestration: per-file and per-source processing, result tables.

Counterpart of :mod:`hsip_tpu.pipeline`: :func:`process_video_file`, the
per-file source runner :func:`process_video_source` and library mode
:func:`process_video_source_library` (every recording of a source through
one batched scan per shape group, :mod:`.track.batch`), the two runners
sharing the checkpoint and run-summary ledger (:class:`_SourceLedger`). The
table writers (:func:`write_results`, :func:`write_position_results`,
:func:`_write_ddt_split_tables`), the exact float64 backend
(:func:`_track_video_exact`), the ledger and the failure cache are copies
of the JAX package's, so the tables are byte-identical; the map phase and
the device scans run on a torch ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import open_video
from .kernels._build import KernelError
from .kernels.reference import is_empty_frame, subtract_scalar_background
from .track.config import FlameDetectorConfig, VideoSourceConfig
from .track.host_scan import MIN_SIGNAL_FRACTION, NOISE_THRESHOLD_FLOOR, TrackingOutput
from .track.scan import track_video
from .track.tracker import FlameDetector
from .utils.backend import resolve_device
from .utils.logging import get_logger
from .utils.profiling import StageTimes
from .video import SpatialCalibration

__all__ = ["process_video_file", "process_video_source",
           "process_video_source_library", "write_results",
           "write_position_results", "BACKENDS", "RESULT_COLUMNS"]

_log = get_logger("pipeline")

_FIGURES_NEED_MATPLOTLIB = (
    "figures (save_frame_images, save_stacked_sequences) are drawn with "
    "matplotlib, which is not installed: install it (the package's 'viz' "
    "extra), or turn the figures off (--no-images --no-sequences)"
)

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


def write_results(output_dict: dict, path) -> Path:
    """Generic space-delimited table writer: column-name → value-list dict.

    Utility counterpart of :func:`write_position_results` for ad-hoc tables
    (reference analogue: ``process_videos.py:766-780``).
    """
    path = Path(path)
    fieldnames = list(output_dict.keys())
    n_rows = len(next(iter(output_dict.values()))) if output_dict else 0
    with open(path, "w") as f:
        f.write(" ".join(str(k) for k in fieldnames) + "\n")
        for i in range(n_rows):
            f.write(" ".join(str(output_dict[k][i]) for k in fieldnames) + "\n")
    return path


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



def _require_figure_renderer(config, save_images=None, write_outputs=True) -> None:
    """Raise ``ModuleNotFoundError`` when ``config`` asks for figures (read
    as :func:`process_video_file` reads it) and matplotlib, an optional
    dependency, cannot be imported. The runners call it before they open
    any recording: a figure step that failed after the tracking lost the
    recording's tables."""
    images = config.save_frame_images if save_images is None else save_images
    if not (write_outputs and config.output_dir
            and (images or config.save_stacked_sequences)):
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ModuleNotFoundError(_FIGURES_NEED_MATPLOTLIB, name="matplotlib") from exc


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
    stage_times=None,
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
    runs only when named (``device="cpu"``). Figures need matplotlib: a
    call that asks for them without it raises ``ModuleNotFoundError``
    before the recording is opened.

    ``stage_times`` (a :class:`~hsip_tpu_torch.utils.StageTimes`) takes
    this call's stages ``open`` (open and close), ``background`` (frame
    0's max) and ``write_tables``, and is handed to the tracking function
    as given, None included, which then adds its own.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"Unknown backend: {backend!r} (expected 'gpu', 'device' or 'exact')"
        )
    dev = resolve_device(device) if backend != "exact" else None
    _require_figure_renderer(config, save_images, write_outputs)
    stages = StageTimes() if stage_times is None else stage_times
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

    with stages.stage("open"):
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

        with stages.stage("background"):
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
            stage_times=stage_times,
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
            with stages.stage("write_tables"):
                _write_ddt_split_tables(output, output_dir, cihx_file.stem,
                                        verbose)
            if verbose:
                print("\nResults summary:")
                print(f"  Total detections: {len(output.rows)}")
        return output
    finally:
        with stages.stage("open"):
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


class _SourceLedger:
    """Checkpoint + run-summary scaffolding shared by the batch runners.

    Both :func:`process_video_source` and
    :func:`process_video_source_library` need identical crash-safe batch
    semantics: a rank-scoped :class:`BatchCheckpoint` ledger (cleared on
    fresh runs, consulted on ``resume``), a barrier so all ranks finish
    ledger setup before anyone marks progress, and a cumulative
    ``run-summary.json``. Keeping them in one helper means a fix to the
    ledger semantics lands in both runners at once.

    Each wait for the other ranks (the processor's barrier) is timed in
    ``stages`` as ``rank_wait``; without a processor there is none.
    """

    def __init__(self, config, detector_config, backend_tag: str,
                 processor, resume: bool, stages: StageTimes):
        import hashlib

        from .utils.checkpoint import BatchCheckpoint
        from .utils.summary import RunSummary

        self._config = config
        self._processor = processor
        self._resume = resume
        self._stages = stages
        self._rank = processor.rank if processor is not None else 0
        self.checkpoint = None
        self.summary = None
        if config.output_dir:
            cfg_hash = hashlib.sha256(
                repr((config, detector_config, backend_tag)).encode()
            ).hexdigest()[:16]
            self.checkpoint = BatchCheckpoint(
                config.output_dir, run_config_hash=cfg_hash, rank=self._rank
            )
            if not resume:
                self.checkpoint.clear()
            if processor is not None:
                # All ranks finish ledger setup before anyone marks progress.
                self._rank_wait()
            self.summary = RunSummary(
                config.name,
                config_echo={"source": config, "detector": detector_config,
                             "backend": backend_tag},
            )
            if resume:
                # Accumulate onto the previous run's records: files skipped
                # via the checkpoint keep their entries; retried files
                # replace theirs.
                self.summary.seed_from(config.output_dir, rank=self._rank)

    def _rank_wait(self):
        with self._stages.stage("rank_wait"):
            self._processor.barrier()

    def ledger_key(self, path) -> str:
        """Per-recording ledger key: the path relative to the source's
        video_path. Discovery is recursive, so two recordings with the
        same basename can live in different subdirectories — keyed by
        basename, a resume run would skip the second as already done
        (while a fresh run processes both, last table wins). For flat
        layouts the relative path IS the basename, so existing ledgers
        stay valid; paths outside the source root fall back to basename.
        """
        p = Path(path)
        try:
            return p.resolve().relative_to(
                Path(self._config.video_path).resolve()
            ).as_posix()
        except (ValueError, OSError):
            return p.name

    def filter_pending(self, files, announce=None):
        """Drop files already complete in the ledger (resume runs only)."""
        if not (self._resume and self.checkpoint is not None):
            return list(files)
        kept = []
        for f in files:
            if self.checkpoint.is_done(self.ledger_key(f)):
                if announce is not None:
                    announce(f)
            else:
                kept.append(f)
        return kept

    def add_failure(self, name, exc):
        if self.summary is not None:
            self.summary.add_failure(name, exc)

    def record(self, filepath, output, wall_s: float):
        """Mark a recording complete and add its summary entry.

        The ledger keys on the video_path-relative path; the summary and
        calibration lookup use the basename (calibration patterns match
        on the FILENAME — reference semantics)."""
        name = Path(filepath).name
        if self.checkpoint is not None:
            self.checkpoint.mark_done(
                self.ledger_key(filepath), rows=len(output.rows)
            )
        if self.summary is not None:
            cal, off = self._config.get_calibration_for_file(name)
            self.summary.add_file(
                name, output, cal, off, wall_s, output.total_frames
            )

    def finish(self):
        """Write the cumulative summary (if dirty) and sync ranks."""
        if (self.summary is not None and self.summary.dirty
                and self._config.output_dir):
            # Resume runs are seeded from the previous summary above, so the
            # write is cumulative; a run that recorded nothing (everything
            # checkpoint-skipped) leaves the previous summary untouched.
            self.summary.write(self._config.output_dir, rank=self._rank)
        if self._processor is not None:
            self._rank_wait()


def _file_fingerprint(path: Path):
    st = path.stat()
    return (st.st_mtime_ns, st.st_size)


def _skip_known_failure(failure_cache, path: Path) -> bool:
    """True when ``path`` failed before and is unchanged since (serve mode).

    Watch mode retries every not-yet-completed recording each poll pass; a
    permanently corrupt file would otherwise fail (and warn) forever at the
    poll interval. A failed file is retried only once its mtime/size change.
    """
    if failure_cache is None:
        return False
    fp = failure_cache.get(str(path))
    if fp is None:
        return False
    try:
        return _file_fingerprint(path) == fp
    except OSError:
        return True  # vanished since the failure — nothing to retry


def _pre_attempt_fingerprint(failure_cache, path: Path):
    """Fingerprint taken BEFORE processing: a file still being copied can
    finish (and change) DURING a failed attempt — stamping it afterwards
    would freeze the completed file's fingerprint and skip it forever.
    With the pre-attempt stamp, any change since the failed open makes the
    next poll's comparison differ and the file is retried."""
    if failure_cache is None:
        return None
    try:
        return _file_fingerprint(path)
    except OSError:
        return None


def _is_device_failure(exc: BaseException, dev) -> bool:
    """True for an error of the device or a kernel, not of one recording:
    the batch runners raise it instead of warning and moving on. A
    :class:`KernelError` always; on a CUDA device also what torch raises
    for a fault that surfaces later than its launch (an illegal access
    reported at the next synchronisation, out of memory). Such an error is
    sticky: every later recording would fail the same way. ``dev`` is
    ``None`` for the ``exact`` backend, which runs on no device: there only
    a :class:`KernelError` counts."""
    import torch

    if isinstance(exc, KernelError):
        return True
    if dev is None or dev.type != "cuda":
        return False
    device_errors = (torch.cuda.OutOfMemoryError,
                     getattr(torch, "AcceleratorError", torch.cuda.OutOfMemoryError))
    if isinstance(exc, device_errors):
        return True
    text = str(exc)
    return isinstance(exc, RuntimeError) and (
        text.startswith(("CUDA", "cuda")) or "CUDA error" in text)


def _record_failure_fingerprint(failure_cache, path: Path, fingerprint) -> None:
    if failure_cache is None or fingerprint is None:
        return
    failure_cache[str(path)] = fingerprint


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


def _discover_source_files(config, processor, verbose, is_root, stages,
                           mode_banner=""):
    """Shared batch-runner prologue: banner, rglob discovery, and
    per-process distribution. A discovery/distribution fix here lands in
    BOTH runners.

    Returns ``None`` when the source has nothing at all (no path / no
    recordings — a state every process observes identically), or this
    process's file list after distribution. The distinction matters under a
    processor: a rank whose SUBSET is empty (fewer files than ranks) gets
    ``[]`` and must still run the ledger path — its barriers have to align
    with the ranks that did receive files; returning early would pair its
    next barrier with a different pass's and desynchronize the whole run.

    Under a processor, ``stages`` counts ``rank_recordings`` (the
    recordings this process was given).
    """
    if verbose and is_root:
        print(f"\n{'=' * 60}")
        print(f"Processing{mode_banner}: {config.name}")
        print(f"Video path: {config.video_path}")
        print(f"Default calibration: {config.calibration} m/pixel")
        print(f"{'=' * 60}")
    if not config.video_path:
        return None
    cihx_files = sorted(Path(config.video_path).rglob("*.cihx"))
    if not cihx_files:
        if verbose and is_root:
            print(f"No CIHX files found in {config.video_path}")
        return None
    if processor is not None:
        my_indices = set(processor.distribute_indices(len(cihx_files)))
        cihx_files = [f for i, f in enumerate(cihx_files) if i in my_indices]
        stages.count("rank_recordings", len(cihx_files))
    return cihx_files


def process_video_source(
    config: VideoSourceConfig,
    detector_config: Optional[FlameDetectorConfig] = None,
    backend: str = "gpu",
    processor=None,
    verbose: bool = True,
    resume: bool = False,
    failure_cache: Optional[dict] = None,
    device=None,
    stage_times=None,
) -> List[TrackingOutput]:
    """Process every ``*.cihx`` under a source's video path, each through
    :func:`process_video_file` with ``backend`` on ``device`` (``None``
    means ``cuda``; without a card the call raises before any file is
    touched).

    With a ``processor`` (any object with ``rank``, ``is_root``,
    ``distribute_indices`` and ``barrier``), whole videos are distributed
    across processes (video-axis data parallelism — each video's scan stays
    serial-identical); outputs are written by the owning process.

    ``resume=True`` skips recordings already marked complete in the output
    directory's checkpoint ledger (crash-safe batch restarts); a
    ``run-summary.json`` is written either way.

    ``failure_cache`` (serve mode) is a caller-held dict mapping failed
    recording paths to their mtime/size fingerprints: unchanged failures are
    skipped on later passes instead of warning at every poll.

    A recording that cannot be read or processed is warned about and left
    for ``resume``; a kernel that does not build or launch
    (:class:`~hsip_tpu_torch.kernels._build.KernelError`) is raised, and so
    is a CUDA error that torch reports later (:func:`_is_device_failure`).
    Figures without matplotlib raise ``ModuleNotFoundError`` before any
    file is touched (:func:`_require_figure_renderer`).

    ``stage_times`` takes the stages ``discover`` and ``ledger``, with a
    processor ``rank_wait`` (inside ``ledger``) and the counter
    ``rank_recordings``, and is handed to :func:`process_video_file` as
    given, None included.
    """
    import time as _time

    if backend not in BACKENDS:
        raise ValueError(
            f"Unknown backend: {backend!r} (expected 'gpu', 'device' or 'exact')"
        )
    dev = resolve_device(device) if backend != "exact" else None
    _require_figure_renderer(config)
    stages = StageTimes() if stage_times is None else stage_times
    is_root = processor is None or processor.is_root
    with stages.stage("discover"):
        cihx_files = _discover_source_files(config, processor, verbose,
                                            is_root, stages)
    if cihx_files is None:
        return []  # globally nothing — every rank takes this branch

    with stages.stage("ledger"):
        ledger = _SourceLedger(config, detector_config, backend, processor,
                               resume, stages)

    def _announce_skip(f):
        if verbose and is_root:
            print(f"  Skipping {f.name} (already complete)")

    outputs = []
    try:
        with stages.stage("ledger"):
            pending = ledger.filter_pending(cihx_files, _announce_skip)
        for cihx_file in pending:
            if _skip_known_failure(failure_cache, cihx_file):
                continue
            fingerprint = _pre_attempt_fingerprint(failure_cache, cihx_file)
            t0 = _time.perf_counter()
            try:
                output = process_video_file(
                    cihx_file,
                    config,
                    detector_config,
                    backend=backend,
                    verbose=verbose and is_root,
                    device=dev,
                    stage_times=stage_times,
                )
            except Exception as exc:
                if _is_device_failure(exc, dev):
                    raise
                # Batch semantics match VideoCollection.from_directory: one
                # unreadable or corrupt recording must not abort the batch
                # run. Warn, record in the summary, leave it unmarked
                # in the checkpoint so --resume retries it.
                print(f"Warning: Could not process {cihx_file}: {exc}")
                _log.warning("failed %s: %s", cihx_file.name, exc)
                ledger.add_failure(cihx_file.name, exc)
                _record_failure_fingerprint(failure_cache, cihx_file,
                                            fingerprint)
                continue
            if failure_cache is not None:
                failure_cache.pop(str(cihx_file), None)
            wall = _time.perf_counter() - t0
            _log.debug(
                "processed %s: rows=%d empty=%d break=%s wall=%.3fs",
                cihx_file.name, len(output.rows), output.empty_frame_count,
                output.break_reason, wall,
            )
            outputs.append(output)
            with stages.stage("ledger"):
                ledger.record(cihx_file, output, wall)
    finally:
        # Always write the summary and reach the rank barrier (a raise here
        # would otherwise hang the other ranks in finish()'s barrier).
        with stages.stage("ledger"):
            ledger.finish()
    return outputs


def process_video_source_library(
    config: VideoSourceConfig,
    detector_config: Optional[FlameDetectorConfig] = None,
    processor=None,
    verbose: bool = True,
    resume: bool = False,
    chunk_size: Optional[int] = None,
    mesh=None,
    failure_cache: Optional[dict] = None,
    device=None,
    stage_times=None,
) -> List[TrackingOutput]:
    """Library mode: track EVERY recording of a source with batched scans
    on ``device`` (``None`` means ``cuda``; without a card the call raises).

    The throughput path for many-file runs: all recordings sharing a frame
    shape batch into one on-device scan (one program per shape group
    instead of per file, :func:`hsip_tpu_torch.track.batch.
    track_collection_device`), with identical rows and tables to running
    ``backend='device'`` per file. Table writing, per-file calibration
    lookup, checkpoint/resume, and run summaries match
    :func:`process_video_source`. With ``processor``, whole recordings are
    distributed across processes first, then each process batches its own
    subset. In the run summary, library-mode ``wall_s`` is the batch wall
    clock apportioned evenly over the batch's recordings.

    Figures (``save_frame_images`` / ``save_stacked_sequences``) ARE
    produced: the throughput scan returns positions only, not the per-frame
    detector internals a 12-panel figure draws (candidate markers, search
    bounds, spline prediction), so after the batched scan each requesting
    recording re-runs the per-file figure path (:func:`process_video_file`
    with ``write_tables=False`` — the SAME functions the per-file runner
    uses, so figures are data-identical to per-file mode by construction).
    The replay costs one map phase per video; table throughput is
    unaffected when figures are off.

    With ``mesh`` (a :class:`~hsip_tpu_torch.parallel.mesh.Mesh` with a
    ``'video'`` axis), each shape group's videos are sharded over the
    mesh's slots, each slot tracking its own on its own device (tables
    byte-identical to the unsharded run); ``device`` then defaults to the
    mesh's first slot and serves the figure replay.

    ``stage_times`` takes the stages ``discover``, ``ledger``, ``open``
    (opening the recordings, and closing them) and ``write_tables``, with
    a processor ``rank_wait`` and the counter ``rank_recordings`` as
    :func:`process_video_source` takes them, and
    is handed to the tracking function and the figure replay as given,
    None included.
    """
    import time as _time

    from .track.batch import track_collection_device

    if mesh is not None and device is None:
        device = mesh.devices.flat[0]
    dev = resolve_device(device)
    _require_figure_renderer(config)
    stages = StageTimes() if stage_times is None else stage_times
    detector_config = detector_config or FlameDetectorConfig()
    is_root = processor is None or processor.is_root
    with stages.stage("discover"):
        cihx_files = _discover_source_files(
            config, processor, verbose, is_root, stages,
            mode_banner=" (library mode)"
        )
    if cihx_files is None:
        return []  # globally nothing — every rank takes this branch

    def _announce_skip(f):
        if verbose and is_root:
            print(f"  Skipping {f.name} (already complete)")

    with stages.stage("ledger"):
        ledger = _SourceLedger(config, detector_config, "library", processor,
                               resume, stages)
        cihx_files = ledger.filter_pending(cihx_files, _announce_skip)

    # Open with the collection layer's warn-and-skip batch semantics: one
    # corrupt recording must not abort the library run.
    from .collection import VideoCollection
    from .video import PhotonVideo

    outputs: List[TrackingOutput] = []
    try:
        videos = []
        for f in cihx_files:
            if _skip_known_failure(failure_cache, f):
                continue
            fingerprint = _pre_attempt_fingerprint(failure_cache, f)
            _warn_unmatched_calibration(config, f.name)
            try:
                with stages.stage("open"):
                    videos.append(
                        PhotonVideo(str(f), trigger_frame=config.trigger_frame)
                    )
                if failure_cache is not None:
                    failure_cache.pop(str(f), None)
            except Exception as exc:
                print(f"Warning: Could not load {f}: {exc}")
                _log.warning("failed to open %s: %s", f.name, exc)
                ledger.add_failure(f.name, exc)
                _record_failure_fingerprint(failure_cache, f, fingerprint)

        if videos:
            collection = VideoCollection(videos)
            try:
                t0 = _time.perf_counter()
                outputs = track_collection_device(
                    collection,
                    detector_config,
                    source_config=config,
                    use_absolute_time=config.use_absolute_time,
                    chunk_size=chunk_size,
                    mesh=mesh,
                    device=dev,
                    stage_times=stage_times,
                )
                wall_each = (_time.perf_counter() - t0) / max(1, len(videos))

                output_dir = (
                    Path(config.output_dir) if config.output_dir else None
                )
                if output_dir is not None:
                    output_dir.mkdir(parents=True, exist_ok=True)
                for video, output in zip(videos, outputs):
                    # Per-video guard, same contract as the per-file runner:
                    # one recording's write failure (disk quota, permission)
                    # must not lose the already-computed tables of the rest.
                    try:
                        stem = video.filepath.stem
                        if verbose and is_root:
                            print(f"\n{video.filepath.name}: "
                                  f"{len(output.rows)} rows, "
                                  f"{output.empty_frame_count} empty frames "
                                  f"skipped")
                            if output.tracker.ddt_detected:
                                print(f"  *** DDT DETECTED at frame "
                                      f"{output.tracker.ddt_frame} ***")
                        if output_dir is not None and output.rows:
                            with stages.stage("write_tables"):
                                _write_ddt_split_tables(
                                    output, output_dir, stem,
                                    verbose and is_root,
                                )
                        with stages.stage("ledger"):
                            ledger.record(video.filepath, output, wall_each)
                    except Exception as exc:
                        print(f"Warning: Could not write results for "
                              f"{video.filepath.name}: {exc}")
                        _log.warning("failed to write %s: %s",
                                     video.filepath.name, exc)
                        ledger.add_failure(video.filepath.name, exc)

                # Figures: per-video replay of the per-file figure path
                # (see docstring). Each rank renders its own subset.
                if config.save_frame_images or config.save_stacked_sequences:
                    for video in videos:
                        try:
                            process_video_file(
                                video.filepath, config, detector_config,
                                backend="gpu", verbose=False,
                                write_tables=False, device=dev,
                                stage_times=stage_times,
                            )
                            if verbose and is_root:
                                print(f"  Figures: {video.filepath.name}")
                        except Exception as exc:
                            if _is_device_failure(exc, dev):
                                raise
                            print(f"Warning: Could not render figures for "
                                  f"{video.filepath.name}: {exc}")
                            _log.warning("failed figures for %s: %s",
                                         video.filepath.name, exc)
            finally:
                with stages.stage("open"):
                    collection.close_all()
    finally:
        # Always write the summary and reach the rank barrier — otherwise a
        # failure on one rank leaves the others hung in finish()'s barrier.
        with stages.stage("ledger"):
            ledger.finish()
    return outputs
