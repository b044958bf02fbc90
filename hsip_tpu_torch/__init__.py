"""hsip_tpu_torch — the flame-front tracker in PyTorch and CUDA.

A port of :mod:`hsip_tpu` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
card. The two Pallas kernels of the per-file path become hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use; everything around
them is plain PyTorch on tensors with an explicit ``device``. The package
stands alone: it imports neither :mod:`hsip_tpu` nor JAX.

Layout (mirrors ``hsip_tpu``; each file keeps its counterpart's name):

* ``_native``                 — C++ MRAW codec and FITPACK curfit (g++, ctypes)
* ``io``                      — CIHX/CIH headers, MRAW payloads, synthetic recordings
* ``metadata``, ``video``     — ``PhotonVideo``, timing, calibration; ``open_video``
* ``kernels/reference``       — float64 numpy host ops (the exact backend's)
* ``kernels/preprocess``      — band chain: diff, opening, blur, Sobel, gradient
* ``kernels/cuda_preprocess`` — the fused band-preprocess CUDA kernel
* ``kernels/unpack``          — packed MRAW bytes → pixels on the device
* ``track/{config,tracker,detectors,velocity,spline,fitpack}`` — the float64 tracker
* ``track/host_scan``         — profiles, ``TrackingOutput``, the float64 host scan
* ``track/scan``              — map phase, device scan, ``track_video``
* ``track/device_scan``       — the tracker state machine in plain PyTorch
* ``track/cuda_scan``         — the tracking-scan CUDA kernel
* ``pipeline``                — ``process_video_file`` and the table writer
* ``viz``                     — diagnostic figures (matplotlib, imported on demand)
"""

from typing import Optional, Set

from .metadata import MetadataConfig
from .video import PhotonVideo, PhotonVideoFloat64, SpatialCalibration, TimingInfo

__version__ = "0.1.0"

__all__ = [
    "MetadataConfig",
    "PhotonVideo",
    "PhotonVideoFloat64",
    "SpatialCalibration",
    "TimingInfo",
    "open_video",
    "__version__",
]


def open_video(
    filepath: str,
    metadata_fields: Optional[Set[str]] = None,
    trigger_frame: Optional[int] = None,
    calibration: Optional[SpatialCalibration] = None,
) -> PhotonVideo:
    """Open a single Photron recording (.cihx or .cih metadata path).

    Example:
        >>> video = open_video("experiment.cihx")
        >>> frame = video[0]
    """
    return PhotonVideo(
        filepath,
        metadata_fields=metadata_fields,
        trigger_frame=trigger_frame,
        calibration=calibration,
    )
