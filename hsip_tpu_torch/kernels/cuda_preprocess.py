"""The fused band-preprocess kernel (CUDA, ``csrc/band_profiles.cu``).

Replaces :func:`hsip_tpu.kernels.pallas_preprocess.pallas_band_profiles`
with the same contract: background-subtracted bands (N, B, W) and each
frame's differencing prior (``prior_index``, clamped at 0) → centerline
(sobel, gradient, intensity), each (N, W) float32. The caller zeroes the
rows that have no prior.

:func:`band_profiles_plain` is the same function in plain PyTorch (the
chain of :mod:`.preprocess`); the CPU path and the on-card comparison use
it. :func:`cuda_band_profiles` takes CUDA tensors only and never falls
back. The kernel's tile layout and frame runs live in the CUDA source
only; :func:`band_plan` asks the built library for them, and
:func:`band_profiles_probe` has the kernel count the band bytes it loads.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._build import KernelError
from .preprocess import band_margin, diff_profiles_from_band, gaussian_taps

__all__ = ["band_profiles_plain", "cuda_band_profiles", "band_profiles_probe",
           "band_plan", "BandPlan"]

# The launcher's answer when a band does not fit a block (its halo exceeds
# the tile, or its buffers a block's shared memory).
_TOO_LARGE = -1


class BandPlan(NamedTuple):
    """How the kernel cuts a launch: ``tile`` output columns a block, tile
    rows of ``stride`` floats (the tile and its halo), ``run`` frames a
    block, ``tiles`` x ``runs`` blocks, ``blocks_per_sm`` of them resident
    on an SM."""

    tile: int
    stride: int
    run: int
    tiles: int
    runs: int
    blocks_per_sm: int


def band_plan(n: int, width: int, morphology_kernel_size: int = 3,
              gaussian_sigma: float = 1.5) -> Optional[BandPlan]:
    """The launcher's plan for an (n, B, width) band on the current CUDA
    device, None when the band does not fit a block. Asks the built kernel
    library, so it needs ``nvcc`` and a card."""
    from ._build import load_kernels

    k = int(morphology_kernel_size)
    b = 2 * band_margin(k, gaussian_sigma) + 1
    out = (ctypes.c_int * 6)()
    err = load_kernels().hsip_band_profiles_plan(
        int(n), b, int(width), k, int(gaussian_taps(gaussian_sigma).size), out)
    if err == _TOO_LARGE:
        return None
    if err != 0:
        raise KernelError(f"band_profiles plan failed (cudaError {err})")
    return BandPlan(*out)


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
    same device. Raises on anything else, and when the launch is refused:
    ValueError when the band does not fit the kernel's blocks.
    """
    outs = _launch("hsip_band_profiles", band, prior_index, frame_diff_threshold,
                   morphology_kernel_size, gaussian_sigma)
    if band.shape[0]:
        cuda_band_profiles.launches += 1
    return outs


cuda_band_profiles.launches = 0


def band_profiles_probe(
    band: torch.Tensor,
    prior_index: torch.Tensor,
    frame_diff_threshold: float,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    *,
    runtime_counts: bool = False,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """The band kernel for measurement, outside the main path's launch
    count: as :func:`cuda_band_profiles`, and also the bytes of band tiles
    its blocks copied from device memory, counted by the kernel (a (1,)
    int64 tensor on the card). ``runtime_counts`` runs the instantiation
    with runtime (k, ntaps) also at the (3, 13) default."""
    loaded = torch.zeros(1, dtype=torch.int64, device=band.device)
    outs = _launch("hsip_band_profiles_probe", band, prior_index,
                   frame_diff_threshold, morphology_kernel_size, gaussian_sigma,
                   loaded.data_ptr(), int(runtime_counts))
    return outs, loaded


def _launch(entry, band, prior_index, frame_diff_threshold,
            morphology_kernel_size, gaussian_sigma, *extra):
    k = int(morphology_kernel_size)
    if band.device.type != "cuda":
        raise ValueError(f"the band kernel needs a CUDA tensor, got {band.device}")
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
    outs = tuple(
        torch.empty((n, w), dtype=torch.float32, device=band.device)
        for _ in range(3)
    )
    if n == 0:
        return outs
    from ._build import load_kernels

    taps_c = (ctypes.c_float * taps.size)(*taps.tolist())
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream(band.device).cuda_stream
        err = getattr(load_kernels(), entry)(
            band.data_ptr(), prior_index.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            n, b, w, k, int(taps.size), taps_c,
            float(np.float32(frame_diff_threshold)), stream, *extra,
        )
    if err == _TOO_LARGE:
        raise ValueError(
            f"k={k}, sigma={gaussian_sigma}, W={w}: a band of {b} rows does not "
            f"fit the band kernel's tile and shared memory"
        )
    if err != 0:
        raise KernelError(f"band_profiles kernel launch failed (cudaError {err})")
    return outs
