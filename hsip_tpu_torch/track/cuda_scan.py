"""The tracking-scan kernel (CUDA, ``csrc/tracking_scan.cu``).

Replaces :func:`hsip_tpu.track.pallas_scan.pallas_tracking_scan_batched`:
the tracker state machine for V videos of M frames in one launch, one block
of two warps per video (the position chain in one, every output in the
other), the profile rows copied ahead of use into a shared-memory ring of
two groups of up to 8 frames, all four detectors. Same arguments as
:func:`~hsip_tpu_torch.track.device_scan.tracking_scan_plain`, its plain
version, to whose outputs it must be equal in every field. It takes CUDA
tensors only and never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels._build import KernelError
from .device_scan import METHODS, DeviceScanResult

__all__ = ["cuda_tracking_scan", "ring_depth"]


def ring_depth(method: str, width: int) -> int:
    """Frames in one of the kernel's two ring groups (8, 4, 2 or 1), as its
    launcher chooses them; 0 when two frames' rows exceed shared memory.
    Asks the built kernel library, so it needs ``nvcc``."""
    from ..kernels._build import load_kernels

    return load_kernels().hsip_tracking_scan_ring_depth(METHODS.index(method), int(width))


def _per_video_params(calibration, frame_rate, max_displacement_px, v, dev):
    """The per-video (V,) calibration and frame rate (float32) and
    displacement cap (int32) on the device: one pinned host buffer and one
    copy that does not wait for the stream, as a copy from pageable memory
    would."""
    host = torch.empty((3, v), dtype=torch.int32, pin_memory=True)
    rows = host.numpy()
    for row, name, x, dtype in ((0, "calibration", calibration, np.float32),
                                (1, "frame_rate", frame_rate, np.float32),
                                (2, "max_displacement_px", max_displacement_px,
                                 np.int32)):
        arr = np.asarray(x, dtype=dtype).reshape(-1)
        if arr.size not in (1, v):
            raise ValueError(f"{name} must be a scalar or have shape ({v},)")
        rows[row] = np.broadcast_to(arr, (v,)).astype(dtype).view(np.int32)
    params = host.to(dev, non_blocking=True)
    return params[0].view(torch.float32), params[1].view(torch.float32), params[2]


def _check(t, name, shape, dtype, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def cuda_tracking_scan(
    frame_indices: torch.Tensor,
    sobel_lines,
    gradient_lines,
    empty: torch.Tensor,
    has_prior: torch.Tensor,
    width: int,
    min_gradient_strength,
    sobel_threshold_fraction,
    ddt_velocity_jump,
    calibration,
    frame_rate,
    max_displacement_px=3,
    edge_margin_px: int = 10,
    search_window_px: int = 100,
    exit_margin_px: int = 15,
    method: str = "combined",
    intensity_lines=None,
    method_fraction=0.5,
) -> DeviceScanResult:
    """Launch the scan kernel on the profiles' device and current stream.

    ``frame_indices`` (V, M) int32, ``empty``/``has_prior`` (V, M) bool,
    the profile lines (V, M, W) float32 — sobel and gradient for
    'combined', intensity for the named methods — all contiguous on one
    CUDA device. Per-video ``calibration``, ``frame_rate`` and
    ``max_displacement_px`` are scalars or (V,) arrays.
    """
    if method not in METHODS:
        raise ValueError(f"Unknown detection method: {method!r}")
    prof0 = sobel_lines if method == "combined" else intensity_lines
    if prof0 is None:
        raise ValueError(f"method {method!r} is missing its profile lines")
    dev = prof0.device
    if dev.type != "cuda":
        raise ValueError(f"cuda_tracking_scan needs CUDA tensors, got {dev}")
    if prof0.dim() != 3:
        raise ValueError("profile lines must be (V, M, W)")
    v, m, w = prof0.shape
    if w != width:
        raise ValueError(f"width {width} != profile width {w}")
    if v == 0 or m == 0:
        raise ValueError("empty scan (callers handle zero-size batches)")
    if ring_depth(method, w) == 0:
        raise ValueError(f"width {w}: two frames' rows exceed the kernel's "
                         f"shared memory")
    _check(prof0, "profile lines", (v, m, w), torch.float32, dev)
    prof1 = None
    if method == "combined":
        prof1 = gradient_lines
        _check(prof1, "gradient_lines", (v, m, w), torch.float32, dev)
    _check(frame_indices, "frame_indices", (v, m), torch.int32, dev)
    _check(empty, "empty", (v, m), torch.bool, dev)
    _check(has_prior, "has_prior", (v, m), torch.bool, dev)
    cal, fr, md = _per_video_params(calibration, frame_rate, max_displacement_px,
                                    v, dev)

    def step_out(dtype):
        return torch.empty((v, m), dtype=dtype, device=dev)

    def latch_out():
        return torch.empty((v,), dtype=torch.int32, device=dev)

    res = DeviceScanResult(
        final_position=step_out(torch.int32),
        recorded=step_out(torch.bool),
        is_post_ddt=step_out(torch.bool),
        search_start=step_out(torch.int32),
        search_end=step_out(torch.int32),
        stop_step=latch_out(),
        stop_reason=latch_out(),
        ddt_frame=latch_out(),
        clear_vc_entry=latch_out(),
    )
    from ..kernels._build import load_kernels

    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hsip_tracking_scan(
            frame_indices.data_ptr(), prof0.data_ptr(),
            prof1.data_ptr() if prof1 is not None else None,
            empty.data_ptr(), has_prior.data_ptr(),
            cal.data_ptr(), fr.data_ptr(), md.data_ptr(),
            *(t.data_ptr() for t in res),
            v, m, w, int(edge_margin_px), int(search_window_px),
            int(exit_margin_px), METHODS.index(method),
            float(np.float32(min_gradient_strength)),
            float(np.float32(sobel_threshold_fraction)),
            float(np.float32(ddt_velocity_jump)),
            float(np.float32(method_fraction)),
            stream,
        )
    if err != 0:
        raise KernelError(f"tracking_scan kernel launch failed (cudaError {err})")
    cuda_tracking_scan.launches += 1
    cuda_tracking_scan.videos += v
    return res


cuda_tracking_scan.launches = 0
# Videos over all launches: more than ``launches`` when a launch took V > 1.
cuda_tracking_scan.videos = 0
