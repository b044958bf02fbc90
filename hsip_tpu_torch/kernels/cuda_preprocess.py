"""The fused band-preprocess kernel (CUDA, ``csrc/band_profiles.cu``).

Replaces :func:`hsip_tpu.kernels.pallas_preprocess.pallas_band_profiles`
with the same contract: background-subtracted bands (N, B, W) and each
frame's differencing prior (``prior_index``, clamped at 0) → centerline
(sobel, gradient, intensity), each (N, W) float32. The caller zeroes the
rows that have no prior.

:func:`band_profiles_plain` is the same function in plain PyTorch (the
chain of :mod:`.preprocess`); the CPU path and the on-card comparison use
it. :func:`cuda_band_profiles` takes CUDA tensors only and never falls
back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .preprocess import band_margin, diff_profiles_from_band, gaussian_taps

__all__ = ["band_profiles_plain", "cuda_band_profiles", "TILE_COLS"]

# Output columns per block; must match TILE in csrc/band_profiles.cu. The
# halo of a tile, (k-1) + r_gauss + 1 columns a side, may not exceed it.
TILE_COLS = 128
# Shared memory a Hopper block may use (bytes).
_MAX_SMEM = 232448


def band_profiles_plain(
    band: torch.Tensor,
    prior_index: torch.Tensor,
    frame_diff_threshold: float,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`cuda_band_profiles`."""
    prior_band = band[prior_index.clamp_min(0).long()]
    diff = band - prior_band
    diff = torch.where(diff < frame_diff_threshold, 0.0, diff)
    return diff_profiles_from_band(
        diff, morphology_kernel_size, gaussian_taps(gaussian_sigma)
    )


def cuda_band_profiles(
    band: torch.Tensor,
    prior_index: torch.Tensor,
    frame_diff_threshold: float,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the band kernel on ``band``'s device and current stream.

    ``band`` (N, B, W) float32 contiguous on a CUDA device, with
    ``B = 2*band_margin(k, sigma)+1``; ``prior_index`` (N,) int32 on the
    same device. Raises on anything else, and when the launch is refused.
    """
    k = int(morphology_kernel_size)
    if band.device.type != "cuda":
        raise ValueError(f"cuda_band_profiles needs a CUDA tensor, got {band.device}")
    if band.dtype != torch.float32 or band.dim() != 3 or not band.is_contiguous():
        raise ValueError("band must be a contiguous (N, B, W) float32 tensor")
    n, b, w = band.shape
    if (prior_index.device != band.device or prior_index.dtype != torch.int32
            or prior_index.shape != (n,) or not prior_index.is_contiguous()):
        raise ValueError("prior_index must be a contiguous (N,) int32 tensor "
                         "on the band's device")
    margin = band_margin(k, gaussian_sigma)
    if k < 1 or b != 2 * margin + 1:
        raise ValueError(f"band height {b} != expected {2 * margin + 1}")
    if w < 2:
        raise ValueError(f"band width {w} < 2")
    taps = gaussian_taps(gaussian_sigma)
    halo = margin  # (k-1) + r_gauss + 1 columns on each side of a tile
    smem = 2 * b * (TILE_COLS + 2 * halo) * 4
    if halo > TILE_COLS or smem > _MAX_SMEM:
        raise ValueError(
            f"k={k}, sigma={gaussian_sigma}: halo {halo} / shared memory "
            f"{smem} B exceed the kernel's tile"
        )
    outs = tuple(
        torch.empty((n, w), dtype=torch.float32, device=band.device)
        for _ in range(3)
    )
    if n == 0:
        return outs
    from ._build import load_kernels

    lib = load_kernels()
    taps_c = (ctypes.c_float * taps.size)(*taps.tolist())
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream(band.device).cuda_stream
        err = lib.hsip_band_profiles(
            band.data_ptr(), prior_index.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            n, b, w, k, int(taps.size), taps_c,
            float(np.float32(frame_diff_threshold)), stream,
        )
    if err != 0:
        raise RuntimeError(f"band_profiles kernel launch failed (cudaError {err})")
    cuda_band_profiles.launches += 1
    return outs


cuda_band_profiles.launches = 0
