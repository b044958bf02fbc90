"""Configuration objects for sources, calibration matching and detection.

Parity targets: reference ``scripts/process_videos.py:49-217`` —
``FileCalibration`` (pattern/range matching), ``VideoSourceConfig``,
``FlameDetectorConfig`` (all tunables with identical defaults),
``FlameDetectionResult``. Promoted here from application code into the
library proper, and loadable from TOML/JSON via :mod:`hsip_tpu.cli`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "FileCalibration",
    "VideoSourceConfig",
    "FlameDetectorConfig",
    "FlameDetectionResult",
]


@dataclass
class FileCalibration:
    """Calibration + position offset scoped to files by pattern.

    ``files`` entries may be exact names, substrings, or ``"A:B"`` ranges.
    Range patterns compare the LAST integer found in each name, so
    ``"run-3-:run-10-"`` matches run-3 … run-10 by run number.

    Example:
        >>> FileCalibration(calibration=0.00074, position_offset=0.0,
        ...                 files=["Run-001:Run-005"])
    """

    calibration: float  # physical units (m) per pixel
    position_offset: float = 0.0  # added to detected position (m)
    files: List[str] = field(default_factory=list)

    def matches(self, filename: str) -> bool:
        """True when any pattern (substring or range) matches ``filename``."""
        for pattern in self.files:
            if ":" in pattern:
                start, _, end = pattern.partition(":")
                if self._matches_range(filename, start.strip(), end.strip()):
                    return True
            elif pattern in filename:
                return True
        return False

    @staticmethod
    def _matches_range(filename: str, start: str, end: str) -> bool:
        """Range check on the last integer embedded in each string."""
        start_nums = re.findall(r"\d+", start)
        end_nums = re.findall(r"\d+", end)
        file_nums = re.findall(r"\d+", filename)
        if not start_nums or not end_nums or not file_nums:
            return False
        try:
            return int(start_nums[-1]) <= int(file_nums[-1]) <= int(end_nums[-1])
        except ValueError:
            return False


@dataclass
class VideoSourceConfig:
    """Per-camera processing configuration.

    ``detection_method`` selects the profile detector for the standalone
    detector API ('threshold' | 'gradient' | 'half_maximum' | 'combined');
    the full tracking pipeline always uses the combined
    min-gradient/rightmost-Sobel tracker, matching the reference script.
    """

    name: str
    enabled: bool = False
    calibration: float = 1.0  # m per pixel default
    position_offset: float = 0.0  # m, default
    trigger_frame: Optional[int] = None
    detection_method: str = "combined"
    use_frame_diff: bool = True
    use_absolute_time: bool = True
    skip_frames: List[int] = field(default_factory=list)
    file_calibrations: List[FileCalibration] = field(default_factory=list)
    save_frame_images: bool = True
    save_stacked_sequences: bool = True
    figure_style: str = "full"  # 'full' (12 panels) | 'compact' (4, ~10x faster)

    _video_path: Optional[str] = field(default=None, init=False, repr=False)
    _output_dir: Optional[str] = field(default=None, init=False, repr=False)
    base_path: Optional[str] = field(default=None, repr=False)

    @property
    def video_path(self) -> Optional[str]:
        return self._resolve_path(self._video_path)

    @video_path.setter
    def video_path(self, path: Optional[str]):
        # Store raw; the getter resolves LAZILY so assignment order with
        # base_path doesn't matter (eager resolution silently froze paths
        # against the CWD when base_path was set afterwards).
        self._video_path = path

    @property
    def output_dir(self) -> Optional[str]:
        return self._resolve_path(self._output_dir)

    @output_dir.setter
    def output_dir(self, path: Optional[str]):
        self._output_dir = path

    def _resolve_path(self, path: Optional[str]) -> Optional[str]:
        """Relative paths resolve against ``base_path`` (or the CWD)."""
        if path is None:
            return None
        if os.path.isabs(path):
            return path
        base = Path(self.base_path) if self.base_path else Path.cwd()
        return str((base / path).resolve())

    def get_calibration_for_file(self, filename: str) -> Tuple[float, float]:
        """(calibration, position_offset) for a file: first matching
        :class:`FileCalibration` wins, else the source defaults."""
        for fc in self.file_calibrations:
            if fc.matches(filename):
                return (fc.calibration, fc.position_offset)
        return (self.calibration, self.position_offset)

    def has_calibration_for_file(self, filename: str) -> bool:
        """True when an explicit :class:`FileCalibration` entry matches —
        lets callers flag the silent fall-through to source defaults (a
        common config mistake with "A:B" range patterns, which compare the
        LAST integer in the filename)."""
        return any(fc.matches(filename) for fc in self.file_calibrations)


@dataclass
class FlameDetectorConfig:
    """All flame-front detection tunables (reference-default values)."""

    # Preprocessing (applied in order: frame_diff -> opening -> blur)
    frame_diff_threshold: float = 5.0
    morphology_kernel_size: int = 3
    gaussian_sigma: float = 1.5

    # Detection
    min_gradient_strength: float = 10.0
    edge_margin_px: int = 10
    sobel_threshold_fraction: float = 0.1

    # Tracking constraint
    max_velocity_change_m_s: float = 200.0

    # DDT detection
    ddt_velocity_jump_m_s: float = 1250.0

    # Spline estimator
    use_spline_estimator: bool = True
    spline_smoothing: float = 0.5
    min_points_for_spline: int = 5

    # Search window
    search_window_px: int = 100

    # Domain exit
    exit_margin_px: int = 15

    # Standalone profile detectors (README-documented methods)
    threshold_fraction: float = 0.5          # 'threshold' method: fraction of peak
    half_maximum_fraction: float = 0.5       # 'half_maximum' method

    def __post_init__(self):
        # Fractions of the window peak: a value > 1 can never be crossed
        # (a common percent-vs-fraction config mistake) and <= 0 matches
        # everything. The reference's combined-tracker tunables keep its
        # anything-goes behavior; these two fields are our additions.
        for name in ("threshold_fraction", "half_maximum_fraction"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise ValueError(
                    f"{name} must be in (0, 1], got {v} (use 0.5 for 50%)"
                )


@dataclass
class FlameDetectionResult:
    """Per-frame detection record, including intermediates for visualization."""

    frame_idx: int
    time_s: float

    frame_subtracted: Optional[np.ndarray] = None
    frame_diff: Optional[np.ndarray] = None
    noise_removed: Optional[np.ndarray] = None
    blurred: Optional[np.ndarray] = None
    sobel_output: Optional[np.ndarray] = None
    gradient_output: Optional[np.ndarray] = None

    pos_min_gradient: Optional[int] = None
    pos_rightmost_sobel: Optional[int] = None
    pos_spline_predicted: Optional[int] = None
    search_bounds: Optional[Tuple[int, int]] = None

    final_position: Optional[int] = None

    # Index of the differencing prior (previous processed frame, empty
    # frames included) — lets visualization recompute intermediates exactly.
    prior_frame_idx: Optional[int] = None
