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
* ``collection``              — ``VideoCollection``; ``open_collection``
* ``kernels/reference``       — float64 numpy host ops (the exact backend's)
* ``kernels/preprocess``      — band chain: diff, opening, blur, Sobel, gradient
* ``kernels/cuda_preprocess`` — the fused band-preprocess CUDA kernel
* ``kernels/unpack``          — packed MRAW bytes → pixels on the device
* ``track/{config,tracker,detectors,velocity,spline,fitpack}`` — the float64 tracker
* ``track/host_scan``         — profiles, ``TrackingOutput``, the float64 host scan
* ``track/scan``              — map phase, device scan, ``track_video``
* ``track/device_scan``       — the tracker state machine in plain PyTorch
* ``track/cuda_scan``         — the tracking-scan CUDA kernel
* ``track/batch``             — library mode: shape groups, the chunked group path
* ``track/fused``             — library mode: one device program per group, pipelined
* ``pipeline``                — per-file and per-source runners, the table writer
* ``utils``                   — device choice, logging, stage times, checkpoint, summary
* ``viz``                     — diagnostic figures (matplotlib, imported on demand)
"""

from pathlib import Path
from typing import List, Optional, Set, Union

from .collection import VideoCollection
from .metadata import MetadataConfig
from .video import PhotonVideo, PhotonVideoFloat64, SpatialCalibration, TimingInfo

__version__ = "0.1.0"

__all__ = [
    "MetadataConfig",
    "PhotonVideo",
    "PhotonVideoFloat64",
    "SpatialCalibration",
    "TimingInfo",
    "VideoCollection",
    "open_collection",
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


def open_collection(
    source: Union[str, List[str]],
    pattern: str = "*.cihx",
    recursive: bool = False,
    metadata_fields: Optional[Set[str]] = None,
    trigger_frame: Optional[int] = None,
    calibration: Optional[SpatialCalibration] = None,
) -> VideoCollection:
    """Open multiple recordings as a :class:`VideoCollection`.

    ``source`` may be a directory (globbed with ``pattern``) or an explicit
    list of file paths.
    """
    if isinstance(source, (str, Path)) and Path(source).is_dir():
        return VideoCollection.from_directory(
            source,
            pattern=pattern,
            recursive=recursive,
            metadata_fields=metadata_fields,
            trigger_frame=trigger_frame,
            calibration=calibration,
        )
    if isinstance(source, list):
        return VideoCollection.from_files(
            source,
            metadata_fields=metadata_fields,
            trigger_frame=trigger_frame,
            calibration=calibration,
        )
    raise ValueError("source must be a directory path or list of file paths")
