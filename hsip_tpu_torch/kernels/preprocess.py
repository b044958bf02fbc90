"""Band preprocess in PyTorch: frame-diff → opening → blur → Sobel/gradient.

Counterpart of :mod:`hsip_tpu.kernels.preprocess`. Detection reads only the
centerline row of the Sobel/gradient outputs, and every op of the chain has
a bounded vertical footprint, so only ``2*band_margin+1`` rows around the
centerline are computed (see :func:`band_margin`). Rows are gathered with
reflect indexing, which reproduces scipy's 'reflect' boundary.

The plain chain below keeps the JAX chain's operation order exactly: tap
sums run left to right as ``out = out + t_j * x_j``, the Sobel row smooth
is ``(b0 + 2*b1) + b2`` and the interior gradient is
``(c[j+1] - c[j-1]) * 0.5``. Each PyTorch op rounds once, so nothing is
contracted into an FMA. :func:`band_to_profiles` launches the fused CUDA
kernel (:mod:`.cuda_preprocess`) for a CUDA band and runs this chain only
for a band that lies on the CPU.

The numpy helpers (:func:`band_margin`, :func:`band_folds`,
:func:`reflect_indices`, :func:`gaussian_taps`,
:func:`_check_band_exactness`) are copies: their originals live in a module
that imports JAX at its top.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "band_margin",
    "band_folds",
    "reflect_indices",
    "gaussian_taps",
    "grey_opening_band",
    "blur_band",
    "sobel_gradient_lines",
    "diff_profiles_from_band",
    "band_to_profiles",
    "batch_centerline_profiles",
    "subtract_background",
    "signal_count",
]


def band_margin(morphology_kernel_size: int, gaussian_sigma: float, truncate: float = 4.0) -> int:
    """Vertical half-extent of rows the centerline result depends on."""
    r_open = morphology_kernel_size - 1
    r_gauss = int(truncate * float(gaussian_sigma) + 0.5)
    r_sobel = 1
    return r_open + r_gauss + r_sobel


def band_folds(center: int, margin: int, n: int) -> bool:
    """True when the centerline band extends past the image rows (see
    :func:`hsip_tpu.kernels.preprocess.band_folds`)."""
    return center - margin < 0 or center + margin > n - 1


def _check_band_exactness(k: int, center: int, margin: int, n: int) -> None:
    """Refuse the one configuration the band kernels cannot reproduce: an
    even morphology kernel (asymmetric vertical windows) over a band that
    folds past the image edge. In-tree callers route it to the float64 host
    ops first; this guard protects direct users of the kernel API."""
    if k % 2 == 0 and band_folds(center, margin, n):
        raise ValueError(
            f"even morphology kernel (k={k}) with a folding centerline band "
            f"(margin {margin} at row {center} of {n}) is not exactly "
            f"representable by the band kernels; use the float64 host ops "
            f"(hsip_tpu_torch.kernels.reference) for this geometry"
        )


def reflect_indices(center: int, margin: int, n: int) -> np.ndarray:
    """Row indices [center-margin, center+margin] with scipy 'reflect'
    (symmetric) folding into [0, n): triangle wave of period 2n."""
    idx = np.arange(center - margin, center + margin + 1)
    period = 2 * n
    idx = np.mod(idx, period)  # non-negative: np.mod keeps the divisor's sign
    return np.where(idx >= n, period - 1 - idx, idx).astype(np.int32)


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized Gaussian taps: the host reference's kernel in float32
    (delegates to :func:`.reference.gaussian_kernel1d`, so the tap radius
    cannot drift from :func:`band_margin`)."""
    from .reference import gaussian_kernel1d

    return gaussian_kernel1d(sigma, truncate).astype(np.float32)


def _pad_w(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Symmetric (scipy 'reflect') padding along the last (width) axis."""
    if left == 0 and right == 0:
        return x
    w = x.shape[-1]
    idx = np.arange(-left, w + right) % (2 * w)
    idx = np.where(idx >= w, 2 * w - 1 - idx, idx)
    return x.index_select(-1, torch.from_numpy(idx).to(x.device))


def _sliding_extremum_w(x: torch.Tensor, k: int, op, dilation: bool) -> torch.Tensor:
    """Running min/max along width with reflect boundary (k taps). scipy
    centers an even window left for erosion and right for dilation."""
    if k <= 1:
        return x
    left = k // 2 if not dilation else k - 1 - k // 2
    right = k - 1 - left
    padded = _pad_w(x, left, right)
    w = x.shape[-1]
    out = padded[..., 0:w]
    for off in range(1, k):
        out = op(out, padded[..., off:off + w])
    return out


def _sliding_extremum_rows(x: torch.Tensor, k: int, op) -> torch.Tensor:
    """Running min/max along the row axis, VALID: the band loses k-1 rows
    (the window origin is absorbed by the crop accounting in band_margin)."""
    if k <= 1:
        return x
    nrows = x.shape[-2]
    out = x[..., 0:nrows - k + 1, :]
    for off in range(1, k):
        out = op(out, x[..., off:off + nrows - k + 1, :])
    return out


def grey_opening_band(band: torch.Tensor, k: int) -> torch.Tensor:
    """Grey opening (erosion→dilation, k×k flat) on a row band: reflect
    along width, VALID along rows."""
    ero = _sliding_extremum_w(band, k, torch.minimum, dilation=False)
    ero = _sliding_extremum_rows(ero, k, torch.minimum)
    dil = _sliding_extremum_w(ero, k, torch.maximum, dilation=True)
    return _sliding_extremum_rows(dil, k, torch.maximum)


def blur_band(band: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable Gaussian: reflect along width, VALID along rows."""
    t = [float(v) for v in np.asarray(taps, dtype=np.float32)]
    ntaps = len(t)
    radius = (ntaps - 1) // 2
    padded = _pad_w(band, radius, radius)
    w = band.shape[-1]
    out_h = t[0] * padded[..., 0:w]
    for j in range(1, ntaps):
        out_h = out_h + t[j] * padded[..., j:j + w]
    nrows = band.shape[-2]
    rows = nrows - ntaps + 1
    out = t[0] * out_h[..., 0:rows, :]
    for j in range(1, ntaps):
        out = out + t[j] * out_h[..., j:j + rows, :]
    return out


def sobel_gradient_lines(
    blurred3: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Centerline (Sobel, gradient, intensity) from a 3-row blurred band
    ``(..., 3, W)``: Sobel(axis=1) = [-1,0,1] along width ∘ [1,2,1] along
    rows; gradient = np.gradient along width; intensity = the center row."""
    w = blurred3.shape[-1]
    smoothed = (
        blurred3[..., 0, :] + 2.0 * blurred3[..., 1, :] + blurred3[..., 2, :]
    )
    padded = _pad_w(smoothed, 1, 1)
    sobel_line = padded[..., 2:w + 2] - padded[..., 0:w]
    center = blurred3[..., 1, :]
    interior = (center[..., 2:] - center[..., :-2]) * 0.5
    left = center[..., 1:2] - center[..., 0:1]
    right = center[..., -1:] - center[..., -2:-1]
    gradient_line = torch.cat([left, interior, right], dim=-1)
    return sobel_line, gradient_line, center


def diff_profiles_from_band(
    diff_band: torch.Tensor,
    morphology_kernel_size: int,
    taps: np.ndarray,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thresholded diff band (..., 2M+1, W) → centerline
    (sobel, gradient, intensity)."""
    opened = grey_opening_band(diff_band, morphology_kernel_size)
    blurred = blur_band(opened, taps)
    return sobel_gradient_lines(blurred)


def band_to_profiles(
    band: torch.Tensor,
    prior_index: torch.Tensor,
    frame_diff_threshold: float,
    morphology_kernel_size: int,
    gaussian_sigma: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BG-subtracted band (N, 2M+1, W) → masked (sobel, gradient, intensity)
    centerline profiles, each (N, W) float32; rows whose ``prior_index`` is
    negative are zero.

    A band on a CUDA device goes through the fused CUDA kernel
    (:func:`~hsip_tpu_torch.kernels.cuda_preprocess.cuda_band_profiles`);
    only a band on the CPU takes the plain chain.
    """
    from .cuda_preprocess import band_profiles_plain, cuda_band_profiles

    expected = 2 * band_margin(morphology_kernel_size, gaussian_sigma) + 1
    if band.shape[-2] != expected:
        raise ValueError(
            f"band has {band.shape[-2]} rows; k={morphology_kernel_size}, "
            f"sigma={gaussian_sigma} needs {expected}"
        )
    fn = band_profiles_plain if band.device.type == "cpu" else cuda_band_profiles
    sob, grad, intens = fn(
        band, prior_index, frame_diff_threshold,
        morphology_kernel_size, gaussian_sigma,
    )
    valid = (prior_index >= 0)[:, None]
    return (
        torch.where(valid, sob, 0.0),
        torch.where(valid, grad, 0.0),
        torch.where(valid, intens, 0.0),
    )


def subtract_background(frames: torch.Tensor, background_scalar: float) -> torch.Tensor:
    """Scalar background subtraction clamped at zero (float32)."""
    return torch.clamp_min(frames.to(torch.float32) - background_scalar, 0.0)


def signal_count(sub: torch.Tensor, noise_threshold: float) -> torch.Tensor:
    """Per-frame COUNT of above-noise pixels (int32, exact). The empty-frame
    decision itself is made on the host in float64."""
    return (sub > noise_threshold).sum(dim=(-2, -1), dtype=torch.int32)


def batch_centerline_profiles(
    frames: torch.Tensor,
    background_scalar: float,
    prior_index: torch.Tensor,
    frame_diff_threshold: float,
    noise_threshold: float,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    center_row: Optional[int] = None,
):
    """Decoded frames (N, H, W) → (sobel, gradient, intensity, raw_center,
    signal_counts): the first four (N, W) float32, the counts (N,) int32.
    ``prior_index`` (N,) int32 names each frame's differencing prior in the
    batch (-1: none; its diff-derived rows are zero). Scalars are float32
    values (callers round them with ``np.float32``)."""
    n, h, w = frames.shape
    if center_row is None:
        center_row = h // 2
    margin = band_margin(morphology_kernel_size, gaussian_sigma)
    _check_band_exactness(morphology_kernel_size, center_row, margin, h)
    rows = torch.from_numpy(reflect_indices(center_row, margin, h).astype(np.int64))

    sub = subtract_background(frames, background_scalar)
    counts = signal_count(sub, noise_threshold)
    band = sub.index_select(1, rows.to(sub.device))
    raw_center_lines = band[:, margin, :]
    sob, grad, intens = band_to_profiles(
        band, prior_index, frame_diff_threshold,
        morphology_kernel_size, gaussian_sigma,
    )
    return sob, grad, intens, raw_center_lines, counts
