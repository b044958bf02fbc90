"""Standalone centerline-profile detectors: threshold, gradient, half_maximum.

The reference README documents a ``detection_method`` config with these three
named methods (README.md:132-141) that its code never implemented (SURVEY.md
§2.8); they are implemented here per the documented semantics, operating on a
1-D centerline intensity profile:

* ``threshold``    — rightmost edge of the contiguous high-intensity region
                     (strong signal behind the front; Mini-camera style).
* ``half_maximum`` — first falling-edge crossing of 50% of peak intensity
                     (clean fronts with good contrast; Nova-camera style).
* ``gradient``     — steepest intensity drop (most negative gradient).

All return an integer pixel position or None (no detection). Batched JAX
versions for the device pipeline live in :mod:`hsip_tpu.kernels.preprocess`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .config import FlameDetectorConfig

__all__ = [
    "detect_threshold",
    "detect_half_maximum",
    "detect_gradient",
    "detect_profile",
    "DETECTION_METHODS",
]


def _window(profile: np.ndarray, bounds: Optional[Tuple[int, int]]) -> Tuple[np.ndarray, int]:
    if bounds is None:
        return profile, 0
    start, end = bounds
    start = max(0, int(start))
    end = min(len(profile), int(end))
    return profile[start:end], start


def detect_threshold(
    profile: np.ndarray,
    threshold: Optional[float] = None,
    fraction: float = 0.5,
    min_intensity: float = 0.0,
    bounds: Optional[Tuple[int, int]] = None,
    quantize: bool = False,
) -> Optional[int]:
    """Rightmost edge of the contiguous above-threshold region.

    The threshold defaults to ``fraction`` of the window peak. Scans from the
    peak rightward while the profile stays above threshold — the right edge
    of the *contiguous* bright region containing the peak, which rejects
    detached noise blobs further right.
    """
    win, offset = _window(np.asarray(profile, dtype=np.float64), bounds)
    if win.size == 0:
        return None
    peak = float(np.max(win))
    if quantize:
        # f32-quantized thresholds: bit-identical decisions to the device
        # scan's native float32 compares (see FlameTracker).
        min_intensity = float(np.float32(min_intensity))
    if peak <= min_intensity:
        return None
    if threshold is not None:
        thr = float(threshold)
    elif quantize:
        thr = float(np.float32(np.float32(fraction) * np.float32(peak)))
    else:
        thr = fraction * peak
    peak_idx = int(np.argmax(win))
    mask = win >= thr
    if not mask[peak_idx]:
        return None
    # Walk right from the peak while contiguous above-threshold.
    below = np.nonzero(~mask[peak_idx:])[0]
    edge = peak_idx + (int(below[0]) - 1 if below.size else mask[peak_idx:].size - 1)
    return offset + edge


def detect_half_maximum(
    profile: np.ndarray,
    fraction: float = 0.5,
    min_intensity: float = 0.0,
    bounds: Optional[Tuple[int, int]] = None,
    quantize: bool = False,
) -> Optional[int]:
    """First falling-edge crossing of ``fraction`` × peak, right of the peak.

    Returns the last index (right of the peak) still at or above the
    half-maximum level before the profile first drops below it.
    """
    win, offset = _window(np.asarray(profile, dtype=np.float64), bounds)
    if win.size == 0:
        return None
    peak = float(np.max(win))
    if quantize:
        min_intensity = float(np.float32(min_intensity))
    if peak <= min_intensity:
        return None
    if quantize:
        level = float(np.float32(np.float32(fraction) * np.float32(peak)))
    else:
        level = fraction * peak
    peak_idx = int(np.argmax(win))
    below = np.nonzero(win[peak_idx:] < level)[0]
    if below.size == 0:
        # Never falls below: the edge is the window end.
        return offset + win.size - 1
    if int(below[0]) == 0:
        # The peak itself sits below the level (fraction > 1): there is no
        # half-maximum crossing — returning peak_idx-1 would hand back a
        # position LEFT of (possibly outside) the search window.
        return None
    return offset + peak_idx + int(below[0]) - 1


def detect_gradient(
    profile: np.ndarray,
    min_strength: float = 0.0,
    bounds: Optional[Tuple[int, int]] = None,
    quantize: bool = False,
) -> Optional[int]:
    """Location of the steepest intensity DROP (most negative gradient)."""
    win, offset = _window(np.asarray(profile, dtype=np.float64), bounds)
    if win.size < 2:
        return None
    grad = np.gradient(win)
    min_val = float(np.min(grad))
    if quantize:
        min_strength = float(np.float32(min_strength))
    if min_val >= -min_strength or min_val >= 0:
        return None
    return offset + int(np.argmin(grad))


DETECTION_METHODS = ("threshold", "gradient", "half_maximum", "combined")


def detect_profile(
    profile: np.ndarray,
    method: str,
    config: Optional[FlameDetectorConfig] = None,
    bounds: Optional[Tuple[int, int]] = None,
    quantize: bool = False,
) -> Optional[int]:
    """Dispatch a named detection method over a centerline profile.

    'combined' is not available here — it needs Sobel/gradient images and
    tracker state; use :class:`hsip_tpu.track.FlameDetector` for that.
    """
    config = config or FlameDetectorConfig()
    if method == "threshold":
        return detect_threshold(
            profile,
            fraction=config.threshold_fraction,
            min_intensity=config.min_gradient_strength,
            bounds=bounds,
            quantize=quantize,
        )
    if method == "half_maximum":
        return detect_half_maximum(
            profile,
            fraction=config.half_maximum_fraction,
            min_intensity=config.min_gradient_strength,
            bounds=bounds,
            quantize=quantize,
        )
    if method == "gradient":
        return detect_gradient(
            profile, min_strength=config.min_gradient_strength, bounds=bounds,
            quantize=quantize,
        )
    raise ValueError(
        f"Unknown detection method {method!r}; expected one of "
        f"{DETECTION_METHODS[:-1]} (or 'combined' via FlameDetector)"
    )
