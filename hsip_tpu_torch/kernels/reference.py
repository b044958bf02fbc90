"""Host reference image ops — numpy float64, scipy-parity, scipy-free.

These are the numerical ground truth for the whole framework:

* the TPU kernels (:mod:`hsip_tpu.kernels.preprocess`) are validated against
  them in tests, and
* the exact float64 tracking path uses them directly when bit-identical
  output tables are required.

Each op replicates the corresponding scipy.ndimage call used by the reference
pipeline (``scripts/process_videos.py:398-413``) including boundary modes:

* :func:`grey_opening`   ≡ ``scipy.ndimage.grey_opening(size=(k, k))``
* :func:`gaussian_filter`≡ ``scipy.ndimage.gaussian_filter(sigma)``
* :func:`sobel`          ≡ ``scipy.ndimage.sobel(axis=1)``
* :func:`gradient_x`     ≡ ``np.gradient(img, axis=1)``

scipy's default boundary mode is 'reflect' (a b c d → d c b a | a b c d |
d c b a); all ops here implement it via explicit edge padding.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "reflect_pad",
    "grey_erosion",
    "grey_dilation",
    "grey_opening",
    "gaussian_kernel1d",
    "gaussian_filter",
    "correlate1d_reflect",
    "sobel",
    "gradient_x",
    "subtract_scalar_background",
    "subtract_prior_frame",
    "three_frame_difference",
    "is_empty_frame",
]


def reflect_pad(img: np.ndarray, pad: tuple) -> np.ndarray:
    """Pad with scipy's 'reflect' mode (edge value duplicated: np 'symmetric')."""
    return np.pad(img, pad, mode="symmetric")


# ---------------------------------------------------------------------------
# Grey morphology (flat rectangular structuring element, 'reflect' boundary)
# ---------------------------------------------------------------------------


def _window_bounds(k: int, dilation: bool) -> tuple:
    """Per-axis (left, right) window extents for a flat size-k filter.

    scipy centers even-sized erosion windows left-of-center and flips the
    structuring element for dilation, giving mirrored asymmetry.
    """
    if not dilation:
        left = k // 2
        right = k - 1 - left
    else:
        right = k // 2
        left = k - 1 - right
    return left, right


def _axis_slice(arr: np.ndarray, start: int, stop: int, axis: int) -> np.ndarray:
    """Contiguous-range view along one axis (no copy — window taps over a
    padded array would otherwise duplicate the whole frame per tap, which
    is pure memory traffic on a bandwidth-starved host)."""
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(start, stop)
    return arr[tuple(sl)]


def _sliding_extremum_1d(img: np.ndarray, k: int, axis: int, op, dilation: bool) -> np.ndarray:
    """Running min/max along one axis with reflect boundary."""
    if k <= 1:
        return img
    left, right = _window_bounds(k, dilation)
    pad = [(0, 0)] * img.ndim
    pad[axis] = (left, right)
    padded = reflect_pad(img, tuple(pad))
    n = img.shape[axis]
    out = _axis_slice(padded, 0, n, axis).copy()
    for off in range(1, k):
        op(out, _axis_slice(padded, off, off + n, axis), out=out)
    return out


def grey_erosion(img: np.ndarray, size: tuple) -> np.ndarray:
    """Flat grey erosion (separable sliding minimum), reflect boundary."""
    out = np.asarray(img, dtype=np.float64)
    for axis, k in enumerate(size):
        out = _sliding_extremum_1d(out, int(k), axis, np.minimum, dilation=False)
    return out


def grey_dilation(img: np.ndarray, size: tuple) -> np.ndarray:
    """Flat grey dilation (separable sliding maximum), reflect boundary."""
    out = np.asarray(img, dtype=np.float64)
    for axis, k in enumerate(size):
        out = _sliding_extremum_1d(out, int(k), axis, np.maximum, dilation=True)
    return out


def grey_opening(img: np.ndarray, size: tuple) -> np.ndarray:
    """Grey opening = erosion then dilation; removes bright specks smaller
    than the structuring element."""
    return grey_dilation(grey_erosion(img, size), size)


# ---------------------------------------------------------------------------
# Separable correlation with reflect boundary
# ---------------------------------------------------------------------------


def correlate1d_reflect(img: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """1-D correlation along ``axis`` with scipy's 'reflect' boundary.

    ``kernel`` is indexed so that output[i] = sum_j kernel[j] * in[i + j - r]
    with r = (len-1)//2 (scipy origin-0 convention for odd kernels).
    """
    kernel = np.asarray(kernel, dtype=np.float64)
    k = kernel.size
    r = (k - 1) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, k - 1 - r)
    padded = reflect_pad(np.asarray(img, dtype=np.float64), tuple(pad))
    n = img.shape[axis]
    out = np.zeros(img.shape, dtype=np.float64)
    for j in range(k):
        out += kernel[j] * _axis_slice(padded, j, j + n, axis)
    return out


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized 1-D Gaussian taps, radius = int(truncate*sigma + 0.5)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


def gaussian_filter(img: np.ndarray, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Separable Gaussian blur, reflect boundary (scipy-parity)."""
    kernel = gaussian_kernel1d(sigma, truncate)
    out = np.asarray(img, dtype=np.float64)
    for axis in range(out.ndim):
        out = correlate1d_reflect(out, kernel, axis)
    return out


def sobel(img: np.ndarray, axis: int = 1) -> np.ndarray:
    """Sobel derivative along ``axis``: [-1, 0, 1] on the derivative axis,
    [1, 2, 1] smoothing on every other axis, reflect boundary (scipy-parity).
    """
    out = correlate1d_reflect(img, np.array([-1.0, 0.0, 1.0]), axis)
    for ax in range(img.ndim):
        if ax != axis:
            out = correlate1d_reflect(out, np.array([1.0, 2.0, 1.0]), ax)
    return out


def gradient_x(img: np.ndarray) -> np.ndarray:
    """np.gradient along axis 1: central differences, one-sided at edges."""
    img = np.asarray(img, dtype=np.float64)
    out = np.empty_like(img)
    out[:, 1:-1] = (img[:, 2:] - img[:, :-2]) / 2.0
    out[:, 0] = img[:, 1] - img[:, 0]
    out[:, -1] = img[:, -1] - img[:, -2]
    return out


# ---------------------------------------------------------------------------
# Pipeline primitives (reference scripts/process_videos.py:670-763 parity)
# ---------------------------------------------------------------------------


def subtract_scalar_background(image: np.ndarray, background_scalar: float) -> np.ndarray:
    """Subtract a scalar background, clamping negatives to zero."""
    subtracted = np.asarray(image, dtype=np.float64) - background_scalar
    subtracted[subtracted < 0] = 0
    return subtracted


def subtract_prior_frame(
    current_frame: np.ndarray, prior_frame: np.ndarray, threshold: float = 0.0
) -> np.ndarray:
    """Frame differencing: current - prior, zeroing sub-threshold pixels.

    Isolates the moving flame front from the static background."""
    diff = np.asarray(current_frame, dtype=np.float64) - np.asarray(
        prior_frame, dtype=np.float64
    )
    diff[diff < threshold] = 0
    return diff


def three_frame_difference(
    frame_prev: np.ndarray,
    frame_curr: np.ndarray,
    frame_next: np.ndarray,
    threshold: float = 0.0,
) -> np.ndarray:
    """Motion isolation requiring change in BOTH adjacent transitions:
    min(|curr-prev|, |next-curr|), thresholded."""
    prev = np.asarray(frame_prev, dtype=np.float64)
    curr = np.asarray(frame_curr, dtype=np.float64)
    next_f = np.asarray(frame_next, dtype=np.float64)
    motion = np.minimum(np.abs(curr - prev), np.abs(next_f - curr))
    motion[motion < threshold] = 0
    return motion


def is_empty_frame(
    frame: np.ndarray,
    noise_threshold: float = 50.0,
    min_signal_fraction: float = 0.001,
) -> bool:
    """True when the fraction of pixels above ``noise_threshold`` is below
    ``min_signal_fraction`` (frame is noise-only)."""
    signal_fraction = np.sum(frame > noise_threshold) / frame.size
    return bool(signal_fraction < min_signal_fraction)
