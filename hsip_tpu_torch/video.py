"""Video core (L1): lazy Photron video object, timing, spatial calibration.

Parity target: reference ``src/photron/video.py`` — the ``PhotonVideo``
PIMS-style lazy video with trigger-relative and absolute (PFV4-matching)
timing, spatial calibration, metadata filtering, chaining setters, context
management and a float64 view. Differences by design:

* Decoding is in-tree (:class:`hsip_tpu_torch.io.MRAWReader`), no pyMRAW
  dependency.
* :meth:`PhotonVideo.frame_bytes` exposes the *packed* payload for staging to
  device memory, where :mod:`hsip_tpu_torch.kernels.unpack` decodes on-device.
* :meth:`PhotonVideo.read_batch` returns contiguous decoded frame batches for
  the batched device preprocess path.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from datetime import datetime, timedelta
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Set, Tuple, Union

import numpy as np

from .io.cihx import parse_cihx_xml, read_header
from .io.mraw import MRAWReader, find_mraw_payload
from .metadata import MetadataConfig

__all__ = [
    "SpatialCalibration",
    "TimingInfo",
    "PhotonVideo",
    "PhotonVideoFloat64",
]


@dataclass
class SpatialCalibration:
    """Pixel ↔ physical-unit conversion.

    Attributes:
        scale: physical units per pixel.
        units: unit name ('m', 'mm', ...).
        origin_x / origin_y: pixel coordinates of the physical origin.
    """

    scale: float
    units: str = "m"
    origin_x: float = 0.0
    origin_y: float = 0.0

    def pixels_to_physical(self, pixels: float) -> float:
        """Convert a pixel distance to physical units."""
        return pixels * self.scale

    def physical_to_pixels(self, physical: float) -> float:
        """Convert a physical distance to pixels."""
        return physical / self.scale

    def x_to_physical(self, x_pixels: float) -> float:
        """Convert an x pixel coordinate to physical units (origin-relative)."""
        return (x_pixels - self.origin_x) * self.scale

    def y_to_physical(self, y_pixels: float) -> float:
        """Convert a y pixel coordinate to physical units (origin-relative)."""
        return (y_pixels - self.origin_y) * self.scale


@dataclass
class TimingInfo:
    """Frame ↔ time conversions, trigger-relative and absolute.

    Attributes:
        frame_rate: recording rate (fps).
        trigger_frame: saved-video frame index where the trigger fired (t=0).
        start_frame: first saved frame's offset from the trigger, in camera
            frames (negative = pre-trigger recording).
        pre_trigger_frames: number of saved frames before the trigger.
        recording_datetime: wall-clock start of the recording (from CIHX).
        recorded_frame: camera's internal counter at trigger (from CIHX).
        skip_frame: save-every-Nth-frame factor (1 = no skip).
    """

    frame_rate: int
    trigger_frame: int = 0
    start_frame: int = 0
    pre_trigger_frames: int = 0
    recording_datetime: Optional[datetime] = None
    recorded_frame: int = 0
    skip_frame: int = 1

    def frame_to_time(self, frame_index: int) -> float:
        """Trigger-relative time (s); negative for pre-trigger frames."""
        if self.frame_rate <= 0:
            return 0.0
        return (frame_index - self.trigger_frame) / self.frame_rate

    def frame_to_absolute_time(self, frame_index: int) -> float:
        """Time from recording start (s), matching Photron PFV4:
        ``(start_frame + i * skip_frame) / frame_rate``."""
        if self.frame_rate <= 0:
            return 0.0
        absolute_frame = self.start_frame + frame_index * self.skip_frame
        return absolute_frame / self.frame_rate

    def frame_to_datetime(self, frame_index: int) -> Optional[datetime]:
        """Wall-clock datetime of a frame, when recording_datetime is known."""
        if self.recording_datetime is None or self.frame_rate <= 0:
            return None
        return self.recording_datetime + timedelta(
            seconds=self.frame_to_absolute_time(frame_index)
        )

    def time_to_frame(self, time_seconds: float) -> int:
        """Inverse of :meth:`frame_to_time` (trigger-relative).

        Truncates toward zero like the reference (video.py:259-267) — NOT
        nearest-frame rounding, and pre-trigger (negative) times truncate in
        the opposite direction from post-trigger ones. Kept for parity."""
        if self.frame_rate <= 0:
            return 0
        return int(time_seconds * self.frame_rate) + self.trigger_frame

    @property
    def has_absolute_timing(self) -> bool:
        """True when wall-clock timing is available."""
        return self.recording_datetime is not None and self.frame_rate > 0


class PhotonVideo:
    """Lazy, array-like access to a Photron CIHX/CIH + MRAW recording.

    Frames page in on demand via a memory map and are decoded per access, so
    opening is O(metadata). Supports int/slice indexing (owned copies),
    iteration, trigger-relative and absolute timing, spatial calibration, and
    chaining setters.

    Example:
        >>> video = PhotonVideo("experiment.cihx",
        ...                     trigger_frame=100,
        ...                     calibration=SpatialCalibration(scale=1.5e-5))
        >>> frame = video[0]
        >>> t = video.get_time(0)            # trigger-relative (may be < 0)
        >>> ta = video.get_absolute_time(0)  # PFV4-style absolute time
    """

    def __init__(
        self,
        filepath: Union[str, Path],
        metadata_fields: Optional[Set[str]] = None,
        validate: bool = True,
        trigger_frame: Optional[int] = None,
        calibration: Optional[SpatialCalibration] = None,
    ):
        self._filepath = Path(filepath)

        if validate and not self._filepath.exists():
            raise FileNotFoundError(f"Video file not found: {filepath}")

        suffix = self._filepath.suffix.lower()
        if suffix in (".cihx", ".cih"):
            self._raw_info = read_header(self._filepath)
            payload = find_mraw_payload(self._filepath)
        elif suffix == ".mraw":
            raise ValueError(
                "Opening a bare .mraw requires its .cih/.cihx metadata file; "
                f"pass that path instead of {filepath}"
            )
        else:
            raise ValueError(f"Unsupported video file format: {suffix}")

        width = int(self._raw_info.get("Image Width", 0))
        height = int(self._raw_info.get("Image Height", 0))
        # STORAGE bit depth selects the container decoder ('Color Bit', the
        # field Photron uses for the stored word size); 'EffectiveBit Depth'
        # is the sensor's effective precision and may be smaller (e.g. 12
        # effective bits stored in 16-bit words).
        bit_depth = int(
            self._raw_info.get("Color Bit")
            or self._raw_info.get("EffectiveBit Depth", 16)
        )
        if width <= 0 or height <= 0:
            raise ValueError(f"Invalid image geometry in header of {filepath}")

        # 'EffectiveBit Side' says which end of the storage word holds the
        # sensor's effective bits (reference src/photron/metadata.py:26
        # documents the field as "Bit alignment (Lower/Higher)"). 'Lower' is
        # the standard LSB alignment: values span 0..2**effective-1 directly.
        # 'Higher' means the camera left-shifted values into the MSBs, so raw
        # pixels appear scaled by 2**(storage-effective). Like the reference's
        # loader we validate the field and decode words as stored — never
        # rescale — but we warn on 'Higher' because thresholds tuned for
        # LSB-aligned data will misbehave on x16-scaled pixels.
        side = str(self._raw_info.get("EffectiveBit Side", "Lower")).lower()
        if side not in ("lower", "higher"):
            raise ValueError(
                f"Unsupported EffectiveBit Side {side!r} in header of "
                f"{filepath}; expected 'Lower' or 'Higher'"
            )
        effective_depth = int(self._raw_info.get("EffectiveBit Depth", bit_depth))
        if side == "higher" and effective_depth < bit_depth:
            warnings.warn(
                f"{self._filepath.name}: {effective_depth} effective bits on "
                f"the Higher side of {bit_depth}-bit words — pixel values are "
                f"left-shifted x{2 ** (bit_depth - effective_depth)} by the "
                "camera and are NOT rescaled here (matches the reference "
                "loader); adjust detector thresholds accordingly.",
                stacklevel=2,
            )

        self._reader: Optional[MRAWReader] = MRAWReader(
            payload,
            width=width,
            height=height,
            bit_depth=bit_depth,
            total_frames=self._raw_info.get("Total Frame"),
        )

        # Metadata filtering.
        if metadata_fields is None:
            self._metadata_config = MetadataConfig.for_processing()
        else:
            self._metadata_config = MetadataConfig(fields=metadata_fields)
        self._metadata = self._metadata_config.filter_metadata(self._raw_info)

        # Cached geometry.
        self._len = len(self._reader)
        self._frame_shape = (height, width)
        self._dtype = self._reader.dtype

        # CIHX XML timing metadata (only the .cihx dialect carries it).
        self._cihx_metadata: Dict[str, Any] = {}
        if suffix == ".cihx":
            self._cihx_metadata = parse_cihx_xml(self._filepath)

        # Prefer CIHX-sourced timing when the XML parsed (record_rate > 0).
        if self._cihx_metadata.get("record_rate", 0) > 0:
            frame_rate = self._cihx_metadata["record_rate"]
            start_frame = self._cihx_metadata.get("start_frame", 0)
        else:
            frame_rate = int(self._raw_info.get("Record Rate(fps)", 0))
            start_frame = int(self._raw_info.get("Start Frame", 0))

        if trigger_frame is not None:
            trig_frame = trigger_frame
        else:
            trig_frame = int(self._raw_info.get("Trigger Frame", 0))

        self._timing = TimingInfo(
            frame_rate=frame_rate,
            trigger_frame=trig_frame,
            start_frame=start_frame,
            pre_trigger_frames=trig_frame,
            recording_datetime=self._cihx_metadata.get("recording_datetime"),
            recorded_frame=self._cihx_metadata.get("recorded_frame", 0),
            skip_frame=self._cihx_metadata.get("skip_frame", 1),
        )

        self._calibration = calibration

    # -- identity & metadata -------------------------------------------------

    @property
    def filepath(self) -> Path:
        return self._filepath

    @property
    def metadata(self) -> dict:
        """Filtered metadata dictionary (copy)."""
        return self._metadata.copy()

    @property
    def raw_metadata(self) -> dict:
        """Complete acquisition header (copy)."""
        return self._raw_info.copy()

    @property
    def cihx_metadata(self) -> Dict[str, Any]:
        """Parsed CIHX XML timing metadata (copy)."""
        return self._cihx_metadata.copy()

    @property
    def recording_datetime(self) -> Optional[datetime]:
        return self._timing.recording_datetime

    @property
    def has_absolute_timing(self) -> bool:
        return self._timing.has_absolute_timing

    # -- geometry & acquisition ----------------------------------------------

    @property
    def frame_rate(self) -> int:
        return self._timing.frame_rate

    @property
    def fps(self) -> int:
        """Alias for frame_rate."""
        return self.frame_rate

    @property
    def frame_shape(self) -> Tuple[int, int]:
        """(height, width) of each frame."""
        return self._frame_shape

    @property
    def height(self) -> int:
        return self._frame_shape[0]

    @property
    def width(self) -> int:
        return self._frame_shape[1]

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def bit_depth(self) -> int:
        """EFFECTIVE sensor bit depth (full-scale), falling back to the
        storage word size ('Color Bit') when the header omits it — the
        normalization denominator for :meth:`to_float64`. Note the container
        DECODER is keyed on 'Color Bit', not this."""
        depth = int(
            self._raw_info.get(
                "EffectiveBit Depth", self._raw_info.get("Color Bit", 16)
            )
        )
        return depth if depth > 0 else 16

    @property
    def shutter_speed(self) -> float:
        """Shutter speed in seconds."""
        return float(self._raw_info.get("Shutter Speed(s)", 0.0))

    @property
    def exposure_time(self) -> float:
        """Alias for shutter_speed."""
        return self.shutter_speed

    @property
    def duration(self) -> float:
        """Total saved duration in seconds."""
        if self.frame_rate > 0:
            return len(self) / self.frame_rate
        return 0.0

    @property
    def timing(self) -> TimingInfo:
        return self._timing

    @property
    def trigger_frame(self) -> int:
        return self._timing.trigger_frame

    def describe(self) -> Dict[str, Any]:
        """One dict of the metadata both human dumps print (the CLI's
        ``--info`` and the pipeline's verbose load block) — a single source
        for the field names so the two dumps cannot drift."""
        d: Dict[str, Any] = {
            "frames": len(self),
            "height": self.height,
            "width": self.width,
            "bit_depth": self.bit_depth,
            "frame_rate": self.frame_rate,
            "duration_s": self.duration,
            "trigger_frame": self.trigger_frame,
        }
        if self.has_absolute_timing:
            c = self.cihx_metadata
            d["cihx"] = {
                "recording_datetime": c.get("recording_datetime"),
                "record_rate": c.get("record_rate"),
                "start_frame": c.get("start_frame"),
                "skip_frame": c.get("skip_frame"),
                "irig": c.get("irig_enabled"),
            }
        return d

    # -- calibration -----------------------------------------------------------

    @property
    def calibration(self) -> Optional[SpatialCalibration]:
        return self._calibration

    @calibration.setter
    def calibration(self, value: Optional[SpatialCalibration]) -> None:
        self._calibration = value

    def set_calibration(
        self,
        scale: float,
        units: str = "m",
        origin_x: float = 0.0,
        origin_y: float = 0.0,
    ) -> "PhotonVideo":
        """Set spatial calibration; returns self for chaining."""
        self._calibration = SpatialCalibration(
            scale=scale, units=units, origin_x=origin_x, origin_y=origin_y
        )
        return self

    def set_trigger_frame(self, frame_index: int) -> "PhotonVideo":
        """Re-anchor t=0 at ``frame_index``; returns self for chaining."""
        self._timing = TimingInfo(
            frame_rate=self._timing.frame_rate,
            trigger_frame=frame_index,
            start_frame=self._timing.start_frame,
            pre_trigger_frames=frame_index,
            recording_datetime=self._timing.recording_datetime,
            recorded_frame=self._timing.recorded_frame,
            skip_frame=self._timing.skip_frame,
        )
        return self

    # -- frame access ----------------------------------------------------------

    def __len__(self) -> int:
        return self._len

    def _require_reader(self) -> MRAWReader:
        if self._reader is None:
            raise ValueError("Video is closed")
        return self._reader

    def __getitem__(self, key: Union[int, slice]) -> np.ndarray:
        """Decode frame(s); the returned array is an owned copy.

        >>> frame = video[0]; last = video[-1]; every10 = video[::10]
        """
        reader = self._require_reader()
        if isinstance(key, (int, np.integer)):
            # Negative-index normalization + bounds check live in the reader.
            return reader.read_frame(int(key))
        if isinstance(key, slice):
            return reader.read_frames(key)
        raise TypeError(f"Indices must be integers or slices, not {type(key).__name__}")

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self._len):
            yield self[i]

    def read_batch(self, start: int, stop: int) -> np.ndarray:
        """Decoded contiguous frames [start, stop) as one (n, H, W) array."""
        return self._require_reader().read_frames(slice(start, stop))

    @property
    def supports_packed_frames(self) -> bool:
        """True when full packed frames can decode ON-DEVICE: 10/12-bit
        packing or raw 8/16-bit (for 8-bit the bytes ARE the pixels, but
        shipping them raw still halves the transfer vs decoded uint16).
        Row alignment is NOT required — a frame whose rows straddle byte
        boundaries (odd-width 12-bit, 10-bit width % 4 != 0) still
        decodes as a flat pixel stream, with the band gathered from the
        decoded frame; frame-level packing granularity is guaranteed by
        the open reader (the constructor rejects payloads that violate
        it)."""
        reader = self._reader
        return reader is not None and reader.bit_depth in (8, 10, 12, 16)

    @property
    def supports_packed_band(self) -> bool:
        """True when the minimal-transfer band path is available:
        8/10/12/16-bit with byte-aligned rows and the native codec built
        (the codec computes empty-frame counts host-side so only band
        rows ship)."""
        reader = self._reader
        if reader is None or reader._native is None:
            return False
        if reader.bit_depth == 8:
            return reader._native.has_count8  # the codec's 8-bit count pass
        return (
            reader.bit_depth in (10, 12, 16)
            and reader.row_nbytes is not None
        )

    def band_bytes(self, start: int, stop: int, rows: np.ndarray,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Packed bytes of selected rows for frames [start, stop) — the
        minimal staging payload for band kernels. ``out`` gathers straight
        into a caller-provided buffer (one video's slice of a batched
        staging array)."""
        return self._require_reader().band_bytes(start, stop, rows, out=out)

    def count_above(
        self, start: int, stop: int, background: float, threshold: float
    ) -> Optional[np.ndarray]:
        """Per-frame above-noise counts from packed bytes (native
        10/12/16-bit fast paths; None when unavailable)."""
        return self._require_reader().count_above(start, stop, background, threshold)

    def band_bytes_and_counts(
        self, start: int, stop: int, rows: np.ndarray,
        background: float, threshold: float,
        out: Optional[np.ndarray] = None,
    ):
        """Fused staging pass: band rows AND above-noise counts in ONE
        sweep over the packed payload (the two values ``(band, counts)``;
        ``None`` when the fused native path is unavailable — callers then
        stage by :meth:`frame_bytes` or :meth:`read_batch`). A capped count
        is the reader's (``MRAWReader.band_bytes_and_capped_counts``)."""
        return self._require_reader().band_bytes_and_counts(
            start, stop, rows, background, threshold, out=out
        )

    def frame_bytes(self, start: int, stop: Optional[int] = None) -> np.ndarray:
        """Packed payload bytes of frames [start, stop): the device staging path.

        Copy this to the device (``torch.from_numpy(...).to(device)``) and
        decode there with :func:`hsip_tpu_torch.kernels.unpack.unpack_12bit`
        so raw bytes, not decoded uint16, cross PCIe.
        """
        return self._require_reader().frame_bytes(start, stop)

    def staging_paths(self):
        """The device staging ladder for this recording, best path first.

        Returns ``(read_packed, read_band, count_fn, storage_bit_depth)``:
        ``read_band``+``count_fn`` when only packed band rows need to cross
        to the device (8/10/12/16-bit, byte-aligned rows, native codec);
        ``read_packed`` when full packed frames can decode on-device
        (any 8/10/12/16-bit payload); all None → host decode via
        :meth:`read_batch`. Single source of truth for every map-phase
        caller — the gating rules must never be re-derived at call sites.
        """
        read_packed = self.frame_bytes if self.supports_packed_frames else None
        read_band = count_fn = None
        if self.supports_packed_band:
            read_band = self.band_bytes
            count_fn = self.count_above
        return read_packed, read_band, count_fn, self._require_reader().bit_depth

    # -- timing ------------------------------------------------------------------

    def get_time(self, frame_index: int) -> float:
        """Trigger-relative time (s) of a frame (negative = pre-trigger)."""
        return self._timing.frame_to_time(frame_index)

    def get_absolute_time(self, frame_index: int) -> float:
        """Absolute time (s) from recording start, PFV4-matching."""
        return self._timing.frame_to_absolute_time(frame_index)

    def get_datetime(self, frame_index: int) -> Optional[datetime]:
        """Wall-clock datetime of a frame (requires CIHX timing)."""
        return self._timing.frame_to_datetime(frame_index)

    def get_frame_at_time(self, time_seconds: float) -> np.ndarray:
        """Frame closest to a trigger-relative time, clamped to range."""
        if self.frame_rate <= 0:
            raise ValueError("Cannot get frame by time: frame rate is 0")
        index = self._timing.time_to_frame(time_seconds)
        index = max(0, min(index, self._len - 1))
        return self[index]

    def get_time_range(self, start: float, end: float) -> np.ndarray:
        """Frames within a trigger-relative time range, clamped."""
        if self.frame_rate <= 0:
            raise ValueError("Cannot get frames by time: frame rate is 0")
        start_idx = max(0, self._timing.time_to_frame(start))
        end_idx = min(self._len, self._timing.time_to_frame(end) + 1)
        return self[start_idx:end_idx]

    # -- calibration helpers -------------------------------------------------------

    def pixels_to_physical(self, pixels: float) -> float:
        """Pixel distance → physical units (requires calibration)."""
        if self._calibration is None:
            raise ValueError("No calibration set. Use set_calibration() first.")
        return self._calibration.pixels_to_physical(pixels)

    def physical_to_pixels(self, physical: float) -> float:
        """Physical distance → pixels (requires calibration)."""
        if self._calibration is None:
            raise ValueError("No calibration set. Use set_calibration() first.")
        return self._calibration.physical_to_pixels(physical)

    # -- views & lifecycle -----------------------------------------------------------

    def to_float64(self, normalize: bool = True) -> "PhotonVideoFloat64":
        """Float64 (optionally [0,1]-normalized) view of this video."""
        return PhotonVideoFloat64(self, normalize=normalize)

    def close(self) -> None:
        """Release the memory map; the object must not be used afterwards."""
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __enter__(self) -> "PhotonVideo":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def __repr__(self) -> str:
        return (
            f"<PhotonVideo '{self._filepath.name}' "
            f"frames={len(self)} shape={self.frame_shape} "
            f"dtype={self.dtype} fps={self.frame_rate}>"
        )


class PhotonVideoFloat64:
    """View returning frames as float64, optionally normalized to [0, 1]
    by ``2**bit_depth - 1``."""

    def __init__(self, video: PhotonVideo, normalize: bool = True):
        self._video = video
        self._normalize = normalize
        self._max_value = (2 ** video.bit_depth) - 1

    def __len__(self) -> int:
        return len(self._video)

    def __getitem__(self, key: Union[int, slice]) -> np.ndarray:
        result = self._video[key].astype(np.float64)
        if self._normalize:
            result /= self._max_value
        return result

    def __iter__(self) -> Iterator[np.ndarray]:
        for frame in self._video:
            result = frame.astype(np.float64)
            if self._normalize:
                result /= self._max_value
            yield result

    @property
    def frame_rate(self) -> int:
        return self._video.frame_rate

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return self._video.frame_shape
