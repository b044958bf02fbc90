"""Sharded map phase: per-slot profile computation with a one-band halo.

Counterpart of :mod:`hsip_tpu.parallel.sharding`, which replaces the
reference's MPI frame scatter (``parallel.py:76-115``) with a ``shard_map``:

* the (N, H, W) frame batch is split along the frame axis, one contiguous
  shard a slot of the mesh (:mod:`.mesh`);
* each slot background-subtracts its shard, counts the above-noise pixels
  and gathers the reflect band, on its own device;
* the differencing prior of each shard's FIRST frame is the left slot's
  last band row. Where the JAX package sends it with ``jax.lax.ppermute``,
  it is copied here device to device into row 0 of this slot's band,
  ordered by an event recorded on the left slot's stream and waited on by
  this slot's stream — the halo is never read from the host again;
* each slot then runs the band chain (:func:`~hsip_tpu_torch.kernels.
  preprocess.band_to_profiles`: the CUDA band kernel on a CUDA slot, with
  the halo row as its first row's prior; the plain chain only on a CPU
  slot), and global frame 0 gets zero profiles.

The halo reproduces the serial differencing chain exactly at any slot
count: every frame is differenced against the same prior row as in the
unsharded map phase, by the same kernel. A sharded array is the list of its
shards, in slot order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.preprocess import (
    band_margin,
    band_to_profiles,
    reflect_indices,
    signal_count,
    subtract_background,
)
from ..kernels.unpack import _UNPACKERS
from .mesh import Mesh, frame_sharding

__all__ = [
    "sharded_centerline_profiles",
    "make_sharded_profile_fn",
    "shard_band_profiles",
    "shard_packed_band_profiles",
]


def shard_band_profiles(
    bands: Sequence[torch.Tensor],
    diff_threshold: float,
    *,
    morphology_kernel_size: int,
    gaussian_sigma: float,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The halo exchange and the band chain of one frame-sharded batch.

    ``bands[s]`` is slot s's ``(1 + n_s, B, W)`` float32
    background-subtracted band on the slot's device, its frames in rows
    ``1..n_s``; row 0 is written here: with the left slot's last band row
    (the halo), and with zeros on slot 0, whose first frame is global frame
    0 and has no prior. Returns each slot's ``(sobel, gradient,
    intensity)``, each ``(n_s, W)``, global frame 0's zero. The module's one
    kernel call site, and the SINGLE body shared by the production map
    phase and the dry run, so the dry run checks exactly the math
    production ships.
    """
    bands[0][0].zero_()
    for left, band in zip(bands[:-1], bands[1:]):
        if band.device.type == "cuda":
            halo_ready = torch.cuda.Event()
            halo_ready.record(torch.cuda.current_stream(left.device))
            with torch.cuda.device(band.device):
                torch.cuda.current_stream(band.device).wait_event(halo_ready)
                band[0].copy_(left[-1], non_blocking=True)
        else:
            band[0].copy_(left[-1])
    out = []
    for s, band in enumerate(bands):
        # Row j's prior is row j-1 (the halo for row 1); slot 0's row 1 is
        # global frame 0, without one.
        prior = torch.arange(-1, band.shape[0] - 1, dtype=torch.int32,
                             device=band.device)
        if s == 0:
            prior[1] = -1
        sob, grad, intens = band_to_profiles(
            band, prior, diff_threshold, morphology_kernel_size, gaussian_sigma,
        )
        out.append((sob[1:], grad[1:], intens[1:]))
    return out


def _halo_band(n: int, b: int, w: int, device) -> torch.Tensor:
    """An empty (1 + n, B, W) float32 band: row 0 for the halo."""
    return torch.empty((1 + n, b, w), dtype=torch.float32, device=device)


def shard_packed_band_profiles(
    band_bytes: Sequence[torch.Tensor],
    background: float,
    diff_threshold: float,
    *,
    morphology_kernel_size: int,
    gaussian_sigma: float,
    bit_depth: int,
) -> List[Tuple[torch.Tensor, ...]]:
    """The sharded chain from packed BAND bytes: ``band_bytes[s]`` is slot
    s's ``(n_s, B, row_nbytes)`` uint8 on its device (the native band
    gather's output). Each slot decodes and background-subtracts its band
    as :func:`~hsip_tpu_torch.kernels.unpack.packed_band_profiles` does,
    then :func:`shard_band_profiles`. Returns each slot's ``(sobel,
    gradient, intensity, raw_center)``."""
    bands, raws = [], []
    for packed in band_bytes:
        n, b = packed.shape[:2]
        pixels = _UNPACKERS[bit_depth](packed)
        band = _halo_band(n, b, pixels.shape[-1], packed.device)
        torch.clamp_min(pixels - background, 0.0, out=band[1:])
        raws.append(band[1:, (b - 1) // 2])
        bands.append(band)
    profiles = shard_band_profiles(
        bands, diff_threshold, morphology_kernel_size=morphology_kernel_size,
        gaussian_sigma=gaussian_sigma,
    )
    return [(*p, raw) for p, raw in zip(profiles, raws)]


def make_sharded_profile_fn(
    mesh: Mesh,
    height: int,
    width: int,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    center_row: Optional[int] = None,
    axis_name: str = "frame",
):
    """Build the sharded profile function for fixed geometry.

    Returns ``fn(frames, background, frame_diff_threshold, noise_threshold)
    -> (sobel, gradient, intensity, raw_center, counts)``, each the list of
    its shards in slot order (``(n_s, W)`` float32, the counts ``(n_s,)``
    int32, on the slot's device), where ``frames`` is (N, H, W) — numpy or
    a tensor — with N divisible by the mesh's ``axis_name`` size. Frame i's
    differencing prior is frame i-1 globally (the serial chain); the global
    frame 0 gets zero profiles (no prior), matching the serial first frame.
    """
    if center_row is None:
        center_row = height // 2
    margin = band_margin(morphology_kernel_size, gaussian_sigma)
    if morphology_kernel_size % 2 == 0 and (
        center_row - margin < 0 or center_row + margin > height - 1
    ):
        raise ValueError(
            "Even morphology kernels with a folding centerline band are not "
            "exact under reflect row-gathering; use the host pipeline for "
            f"this geometry (H={height}, k={morphology_kernel_size})"
        )
    rows = reflect_indices(center_row, margin, height).astype(np.int64)
    sharding = frame_sharding(mesh, axis_name)
    n_shards = len(sharding.slots)

    def fn(frames, background, frame_diff_threshold, noise_threshold):
        n = frames.shape[0]
        if n % n_shards:
            raise ValueError(f"{n} frames do not split over {n_shards} slots")
        bg = float(np.float32(background))
        noise = float(np.float32(noise_threshold))
        bands, raws, counts = [], [], []
        for dev, (a, b) in zip(sharding.slots, sharding.bounds(n)):
            local = torch.as_tensor(np.ascontiguousarray(frames[a:b])
                                    if isinstance(frames, np.ndarray)
                                    else frames[a:b]).to(dev)
            sub = subtract_background(local, bg)
            counts.append(signal_count(sub, noise))
            band = _halo_band(b - a, rows.size, width, dev)
            torch.index_select(sub, 1, torch.from_numpy(rows).to(dev), out=band[1:])
            raws.append(band[1:, margin])
            bands.append(band)
        profiles = shard_band_profiles(
            bands, float(np.float32(frame_diff_threshold)),
            morphology_kernel_size=morphology_kernel_size,
            gaussian_sigma=gaussian_sigma,
        )
        sob, grad, intens = (list(x) for x in zip(*profiles))
        return sob, grad, intens, raws, counts

    return fn


def sharded_centerline_profiles(
    frames: np.ndarray,
    background_scalar: float,
    frame_diff_threshold: float,
    noise_threshold: float,
    mesh: Mesh,
    morphology_kernel_size: int = 3,
    gaussian_sigma: float = 1.5,
    axis_name: str = "frame",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One-shot sharded profile computation (pads N to the slot count with
    copies of the last frame, returns the first N rows as numpy).

    Convenience wrapper over :func:`make_sharded_profile_fn`; production
    pipelines build the fn once per geometry and stream chunks through it.
    """
    n, h, w = frames.shape
    n_shards = mesh.shape[axis_name]
    pad = (-n) % n_shards
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)

    fn = make_sharded_profile_fn(
        mesh, h, w, morphology_kernel_size, gaussian_sigma, axis_name=axis_name
    )
    outs = fn(frames, background_scalar, frame_diff_threshold, noise_threshold)
    return tuple(torch.cat([s.cpu() for s in shards]).numpy()[:n] for shards in outs)
