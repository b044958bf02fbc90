"""Tracking layer: detectors, tracker state machine, configs.

Counterpart of ``hsip_tpu/track/__init__.py``. The float64 host layer
(configs, detectors, tracker, spline, velocities) is numpy only and loads
eagerly. The torch-heavy submodules (batch, device_scan) load lazily, so
that metadata, config and figure consumers, the spawned figure-render
workers among them, never import torch.
"""

from .config import (
    FileCalibration,
    FlameDetectionResult,
    FlameDetectorConfig,
    VideoSourceConfig,
)
from .detectors import (
    DETECTION_METHODS,
    detect_gradient,
    detect_half_maximum,
    detect_profile,
    detect_threshold,
)
from .spline import SmoothingSpline, fit_smoothing_spline
from .tracker import FlameDetector, FlameTracker
from .velocity import (
    ddt_frame_from_velocities,
    velocities_from_positions,
    velocity_entries_from_positions,
)

# ``tracking_scan_plain`` stands where the JAX package has
# ``device_tracking_scan``: the tracker state machine in plain device ops.
_LAZY = {
    "track_collection_device": ("batch", "track_collection_device"),
    "ScanHistory": ("batch", "ScanHistory"),
    "tracking_scan_plain": ("device_scan", "tracking_scan_plain"),
    "DeviceScanResult": ("device_scan", "DeviceScanResult"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FileCalibration",
    "FlameDetectionResult",
    "FlameDetectorConfig",
    "VideoSourceConfig",
    "FlameDetector",
    "FlameTracker",
    "SmoothingSpline",
    "fit_smoothing_spline",
    "detect_threshold",
    "detect_half_maximum",
    "detect_gradient",
    "detect_profile",
    "DETECTION_METHODS",
    "track_collection_device",
    "ScanHistory",
    "tracking_scan_plain",
    "velocities_from_positions",
    "velocity_entries_from_positions",
    "ddt_frame_from_velocities",
    "DeviceScanResult",
]
