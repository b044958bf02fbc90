"""Packed MRAW bytes → pixels on the device, in PyTorch.

Counterpart of :mod:`hsip_tpu.kernels.unpack`: the staging path ships the
packed payload (1.5 bytes/px for 12-bit) and decodes where the profiles are
computed. Bytes are widened to int32 before any shift (uint8 shifts would
drop the high bits). The decode stays plain PyTorch here, as in the JAX
package, where it runs outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .preprocess import (
    _check_band_exactness,
    band_margin,
    band_to_profiles,
    reflect_indices,
)

__all__ = [
    "unpack_8bit",
    "unpack_10bit",
    "unpack_12bit",
    "unpack_16bit",
    "rows_byte_aligned",
    "packed_band_profiles",
    "packed_centerline_profiles",
]


def unpack_12bit(packed: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Decode MSB-first 12-bit packed bytes (..., 3k) → pixels (..., 2k)."""
    b = packed.reshape(*packed.shape[:-1], -1, 3).to(torch.int32)
    p0 = (b[..., 0] << 4) | (b[..., 1] >> 4)
    p1 = ((b[..., 1] & 0x0F) << 8) | b[..., 2]
    out = torch.stack([p0, p1], dim=-1)
    return out.reshape(*packed.shape[:-1], -1).to(out_dtype)


def unpack_16bit(packed: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Decode little-endian 16-bit bytes (..., 2k) → pixels (..., k)."""
    b = packed.reshape(*packed.shape[:-1], -1, 2).to(torch.int32)
    return (b[..., 0] | (b[..., 1] << 8)).to(out_dtype)


def unpack_8bit(packed: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """8-bit payload bytes ARE the pixels: a cast."""
    return packed.to(out_dtype)


def unpack_10bit(packed: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Decode MSB-first 10-bit packed bytes (..., 5k) → pixels (..., 4k)."""
    b = packed.reshape(*packed.shape[:-1], -1, 5).to(torch.int32)
    p0 = (b[..., 0] << 2) | (b[..., 1] >> 6)
    p1 = ((b[..., 1] & 0x3F) << 4) | (b[..., 2] >> 4)
    p2 = ((b[..., 2] & 0x0F) << 6) | (b[..., 3] >> 2)
    p3 = ((b[..., 3] & 0x03) << 8) | b[..., 4]
    out = torch.stack([p0, p1, p2, p3], dim=-1)
    return out.reshape(*packed.shape[:-1], -1).to(out_dtype)


_UNPACKERS = {
    8: unpack_8bit,
    10: unpack_10bit,
    12: unpack_12bit,
    16: unpack_16bit,
}


def _unpack_rows(packed: torch.Tensor, rows: np.ndarray, height: int,
                 width: int, bit_depth: int) -> torch.Tensor:
    """Decode only the selected ROWS of packed frames (N, frame_nbytes):
    each row spans ``width * bit_depth // 8`` bytes (callers gate on
    byte-aligned rows), so the full frame is never decoded."""
    row_nbytes = width * bit_depth // 8
    per_row = packed.reshape(packed.shape[0], height, row_nbytes)
    idx = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(packed.device)
    return _UNPACKERS[bit_depth](per_row.index_select(1, idx))


def rows_byte_aligned(width: int, bit_depth: int) -> bool:
    """True when each image row spans a whole number of packed bytes (so a
    row gather can happen on the byte axis before decoding)."""
    return (width * bit_depth) % 8 == 0


def packed_band_profiles(
    band_bytes: torch.Tensor,
    background_scalar: float,
    prior_index: torch.Tensor,
    frame_diff_threshold: float,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    bit_depth: int = 12,
):
    """Packed BAND bytes (N, B, row_nbytes) uint8 → (sobel, gradient,
    intensity, raw_center), all (N, W) float32. The minimal-transfer path:
    the host ships only the band rows and counts the empty-frame pixels
    itself."""
    band_pixels = _UNPACKERS[bit_depth](band_bytes)  # (N, B, W) f32
    band = torch.clamp_min(band_pixels - background_scalar, 0.0)
    margin = (band.shape[1] - 1) // 2
    raw_center_lines = band[:, margin, :]
    sob, grad, intens = band_to_profiles(
        band, prior_index, frame_diff_threshold,
        morphology_kernel_size, gaussian_sigma,
    )
    return sob, grad, intens, raw_center_lines


def packed_centerline_profiles(
    packed: torch.Tensor,
    height: int,
    width: int,
    background_scalar: float,
    prior_index: torch.Tensor,
    frame_diff_threshold: float,
    noise_threshold: float,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    center_row: Optional[int] = None,
    bit_depth: int = 12,
):
    """Packed frames (N, frame_nbytes) uint8 → (sobel, gradient, intensity,
    raw_center, counts): same contract as
    :func:`~hsip_tpu_torch.kernels.preprocess.batch_centerline_profiles`.
    The counts need the whole frame, so it is decoded once; the band comes
    from a byte-row gather when rows are byte-aligned, else from that
    decode."""
    if center_row is None:
        center_row = height // 2
    margin = band_margin(morphology_kernel_size, gaussian_sigma)
    _check_band_exactness(morphology_kernel_size, center_row, margin, height)
    rows = reflect_indices(center_row, margin, height)

    full = _UNPACKERS[bit_depth](packed)
    sub_full = torch.clamp_min(full - background_scalar, 0.0)
    counts = (sub_full > noise_threshold).sum(dim=-1, dtype=torch.int32)
    del sub_full

    if rows_byte_aligned(width, bit_depth):
        band_pixels = _unpack_rows(packed, rows, height, width, bit_depth)
    else:
        idx = torch.from_numpy(rows.astype(np.int64)).to(full.device)
        band_pixels = full.reshape(full.shape[0], height, width).index_select(1, idx)
    band = torch.clamp_min(band_pixels - background_scalar, 0.0)
    raw_center_lines = band[:, margin, :]
    sob, grad, intens = band_to_profiles(
        band, prior_index, frame_diff_threshold,
        morphology_kernel_size, gaussian_sigma,
    )
    return sob, grad, intens, raw_center_lines, counts
