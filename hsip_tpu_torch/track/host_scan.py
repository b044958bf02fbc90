"""The float64 host scan and the map/scan data types.

Copy of the host-side part of :mod:`hsip_tpu.track.scan`: the empty-frame
constants, :class:`FrameProfiles` (the map-phase output),
:class:`TrackingOutput`, the float64 host map phase
(:func:`_compute_profiles_host_exact`) and the sequential float64 tracker
scan (:func:`run_tracking_scan`). The map phase on a torch device and the
device scan are in :mod:`hsip_tpu_torch.track.scan`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .config import FlameDetectorConfig
from .tracker import FlameTracker

__all__ = [
    "MIN_SIGNAL_FRACTION",
    "NOISE_THRESHOLD_FLOOR",
    "FrameProfiles",
    "TrackingOutput",
    "run_tracking_scan",
]

# Empty-frame test constants (reference process_videos.py:1458-1459).
MIN_SIGNAL_FRACTION = 0.0005
NOISE_THRESHOLD_FLOOR = 10.0


@dataclass
class FrameProfiles:
    """Per-video precomputed detection inputs (the map-phase output)."""

    frame_indices: np.ndarray      # (M,) processed frame indices, ascending
    sobel_lines: np.ndarray        # (M, W) float
    gradient_lines: np.ndarray     # (M, W) float
    intensity_lines: np.ndarray    # (M, W) denoised diff centerline (profile
                                   # detector input when use_frame_diff)
    raw_center_lines: np.ndarray   # (M, W) BG-subtracted centerline (profile
                                   # detector input when not use_frame_diff)
    signal_counts: np.ndarray      # (M,) int — above-noise pixel counts
    has_prior: np.ndarray          # (M,) bool — False only for the first
    width: int
    total_pixels: int              # H * W, for the empty-frame fraction

    def select_intensity(self, method: str, use_frame_diff: bool):
        """(profile_lines, has_prior) for a detection method — the single
        source of truth shared by the host scan, the device scan and the
        collection batch path. Named methods on raw (non-diff) profiles
        detect from the very first frame, so has_prior is all-True there.
        """
        if method != "combined" and not use_frame_diff:
            ones = np.ones(self.frame_indices.size, dtype=bool)
            return self.raw_center_lines, ones
        if method == "combined":
            return None, self.has_prior
        return self.intensity_lines, self.has_prior


@dataclass
class TrackingOutput:
    """Scan-phase output for one video."""

    rows: List[Tuple]              # (frame, time_s, pos_px, pos_m, is_post_ddt)
    tracker: FlameTracker
    empty_frame_count: int = 0
    break_frame: Optional[int] = None
    break_reason: Optional[str] = None   # 'exit' | 'velocity_drop' | None
    total_frames: int = 0                # frames in the recording
    #: wall-clock phase attribution: {'map_s', 'scan_s'}. The map phase
    #: free-runs (dispatch without blocking), so device waits it hides are
    #: paid by — and attributed to — the scan phase.
    phase_timings: Optional[dict] = None

    def merged_rows(self) -> List[Tuple]:
        """Rows with velocities merged from the final tracker history:
        (frame, time_s, pos_px, pos_m, v1, v2, vc, is_post_ddt)."""
        vel = {e[0]: (e[1], e[2], e[3]) for e in self.tracker.get_velocity_history()}
        out = []
        for f, t, px, m, is_post in self.rows:
            v1, v2, vc = vel.get(f, (None, None, None))
            out.append((f, t, px, m, v1, v2, vc, is_post))
        return out


def _compute_profiles_host_exact(
    read_batch,
    n_frames: int,
    frame_shape: Tuple[int, int],
    background_scalar: float,
    config: FlameDetectorConfig,
    skip_frames: Sequence[int] = (),
    progress: Optional[Callable[[int, int], None]] = None,
) -> FrameProfiles:
    """Float64 host map phase (kernels.reference): the exactness fallback
    for geometries the band kernels cannot reproduce (even morphology
    kernels with a folding band)."""
    from ..kernels import reference as hostops

    skip = set(int(s) for s in skip_frames)
    processed = np.array(
        [i for i in range(n_frames) if i not in skip], dtype=np.int64
    )
    m = processed.size
    h, w = frame_shape
    noise_threshold = max(NOISE_THRESHOLD_FLOOR, background_scalar * 0.5)
    center = h // 2
    k = config.morphology_kernel_size

    sobel_lines = np.zeros((m, w), dtype=np.float32)
    gradient_lines = np.zeros((m, w), dtype=np.float32)
    intensity_lines = np.zeros((m, w), dtype=np.float32)
    raw_center_lines = np.zeros((m, w), dtype=np.float32)
    signal_counts = np.zeros(m, dtype=np.int64)

    prior_sub = None
    for j, frame_idx in enumerate(processed):
        if progress is not None and j and j % 50 == 0:
            progress(j, m)
        frame = read_batch(int(frame_idx), int(frame_idx) + 1)[0]
        sub = hostops.subtract_scalar_background(frame, background_scalar)
        signal_counts[j] = int(np.sum(sub > noise_threshold))
        raw_center_lines[j] = sub[center]
        if prior_sub is not None:
            diff = hostops.subtract_prior_frame(
                sub, prior_sub, config.frame_diff_threshold
            )
            opened = hostops.grey_opening(diff, (k, k))
            blurred = hostops.gaussian_filter(opened, config.gaussian_sigma)
            sobel_lines[j] = hostops.sobel(blurred, axis=1)[center]
            gradient_lines[j] = hostops.gradient_x(blurred)[center]
            intensity_lines[j] = blurred[center]
        prior_sub = sub

    has_prior = np.ones(m, dtype=bool)
    if m:
        has_prior[0] = False
    return FrameProfiles(
        frame_indices=processed,
        sobel_lines=sobel_lines,
        gradient_lines=gradient_lines,
        intensity_lines=intensity_lines,
        raw_center_lines=raw_center_lines,
        signal_counts=signal_counts,
        has_prior=has_prior,
        width=w,
        total_pixels=h * w,
    )


def run_tracking_scan(
    profiles: FrameProfiles,
    config: FlameDetectorConfig,
    frame_rate: float,
    calibration_m_per_px: float,
    position_offset_m: float = 0.0,
    time_fn: Optional[Callable[[int], float]] = None,
    on_result=None,
    detection_method: str = "combined",
    use_frame_diff: bool = True,
) -> TrackingOutput:
    """Scan phase: sequential tracker over precomputed profiles.

    Replicates the reference frame loop exactly (empty skip → detect → exit
    check → velocity-drop check → record), in float64 on host.

    ``on_result(result, tracker)`` is invoked per detection (for viz hooks).

    Thresholds quantize to float32 here (profiles are f32), making every
    threshold decision bit-identical to the on-device lax.scan backend —
    the two scans differ by construction in NOTHING, not just "within
    margins". The full-frame float64 ``FlameDetector`` (exact backend)
    keeps pure f64 thresholds; its anchor is the scipy oracle.
    """
    tracker = FlameTracker(
        config, frame_rate, calibration_m_per_px, quantize_thresholds=True
    )
    rows: List[Tuple] = []
    empty_count = 0
    break_frame = None
    break_reason = None

    if time_fn is None:
        time_fn = lambda i: i / frame_rate if frame_rate > 0 else 0.0  # noqa: E731

    width = profiles.width
    total_px = profiles.total_pixels
    # Single source of truth for profile selection (shared with the device
    # and collection scans).
    intensity_lines, detect_gate = profiles.select_intensity(
        detection_method, use_frame_diff
    )

    for j, frame_idx in enumerate(profiles.frame_indices):
        frame_idx = int(frame_idx)
        time_s = time_fn(frame_idx)

        # Empty-frame skip: advances the prior chain (already baked into the
        # precomputed diffs) but never touches tracker state.
        if profiles.signal_counts[j] / total_px < MIN_SIGNAL_FRACTION:
            empty_count += 1
            continue

        if profiles.has_prior[j]:
            sobel_line = np.asarray(profiles.sobel_lines[j], dtype=np.float64)
            gradient_line = np.asarray(profiles.gradient_lines[j], dtype=np.float64)
        else:
            sobel_line = None
            gradient_line = None
        intensity_line = (
            np.asarray(intensity_lines[j], dtype=np.float64)
            if intensity_lines is not None and detect_gate[j]
            else None
        )

        # Spline prediction is plot-only; skip it unless a viz hook consumes
        # the result (an every-frame refit would make the scan O(N^2)).
        result = tracker.step(
            frame_idx, width, sobel_line, gradient_line,
            predict_spline=on_result is not None,
            intensity_line=intensity_line,
            method=detection_method,
        )
        if on_result is not None:
            if j > 0:
                result.prior_frame_idx = int(profiles.frame_indices[j - 1])
            on_result(result, tracker)

        flame_position = result.final_position
        velocity = tracker.last_velocity

        # Domain-exit check BEFORE recording: at-edge positions carry
        # artificially low velocity and must not enter the table.
        if (
            flame_position is not None
            and flame_position >= width - config.exit_margin_px
        ):
            tracker.clear_last_central_difference()
            break_frame, break_reason = frame_idx, "exit"
            break

        # Sudden >50% velocity drop (edge artifact short of the margin).
        prev_v1, _latest = tracker.last_two_v1()
        if velocity is not None and prev_v1 is not None and prev_v1 > 100:
            if (prev_v1 - velocity) / prev_v1 > 0.5:
                tracker.clear_last_central_difference()
                break_frame, break_reason = frame_idx, "velocity_drop"
                break

        if flame_position is not None:
            pos_m = flame_position * calibration_m_per_px + position_offset_m
            is_post_ddt = tracker.ddt_detected and frame_idx >= tracker.ddt_frame
            rows.append((frame_idx, time_s, flame_position, pos_m, is_post_ddt))

    return TrackingOutput(
        rows=rows,
        tracker=tracker,
        empty_frame_count=empty_count,
        break_frame=break_frame,
        break_reason=break_reason,
    )
