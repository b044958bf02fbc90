"""Synthetic CIHX/MRAW generation — golden data for tests and benchmarks.

The reference repository ships no sample videos, so all correctness and
performance work rests on synthetic recordings with *analytically known*
flame-front trajectories. This module writes spec-conformant CIHX (binary
preamble + XML) and CIH (text) metadata plus packed MRAW payloads that the
framework's own readers — and, where installed, pyMRAW — can open.

The flame model (:func:`synthesize_flame_video`) renders a bright region
propagating left→right along the image with a sharp leading edge, optional
acceleration and a DDT-style velocity jump, so detector output tables can be
asserted against the analytic trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .mraw import pack_10bit, pack_12bit

__all__ = [
    "CihxSpec",
    "write_cihx",
    "write_cih",
    "write_mraw",
    "write_recording",
    "synthesize_flame_video",
    "FlameSpec",
]

PathLike = Union[str, Path]


@dataclass
class CihxSpec:
    """Metadata fields for a synthetic recording."""

    width: int
    height: int
    total_frames: int
    record_rate: int = 100_000
    bit_depth: int = 12
    start_frame: int = 0
    skip_frame: int = 1
    trigger_frame: int = 0
    recorded_frame: int = 0
    shutter_speed_ns: int = 2_000
    irig: int = 0
    date: str = "2026/1/15"
    time: str = "12:00:00"
    device_name: str = "FASTCAM Synthetic"
    # Stored word size ('Color Bit'); defaults to the container bit depth.
    color_bit: Optional[int] = None
    effective_bit_side: str = "Lower"
    file_format: str = "MRaw"
    comment: str = ""


def _cihx_xml(spec: CihxSpec) -> bytes:
    """Render the embedded <cih> XML document (text fields escaped)."""
    from xml.sax.saxutils import escape

    comment = escape(str(spec.comment))
    device_name = escape(str(spec.device_name))
    date = escape(str(spec.date))
    time_s = escape(str(spec.time))
    file_format = escape(str(spec.file_format))
    xml = f"""<?xml version="1.0" encoding="UTF-8"?>
<cih>
  <fileInfo>
    <date>{date}</date>
    <time>{time_s}</time>
    <fileFormat>{file_format}</fileFormat>
    <comment>{comment}</comment>
  </fileInfo>
  <recordInfo>
    <recordRate>{spec.record_rate}</recordRate>
    <shutterSpeedNsec>{spec.shutter_speed_ns}</shutterSpeedNsec>
  </recordInfo>
  <frameInfo>
    <totalFrame>{spec.total_frames}</totalFrame>
    <recordedFrame>{spec.recorded_frame}</recordedFrame>
    <startFrame>{spec.start_frame}</startFrame>
    <skipFrame>{spec.skip_frame}</skipFrame>
    <triggerFrame>{spec.trigger_frame}</triggerFrame>
  </frameInfo>
  <imageDataInfo>
    <resolution>
      <width>{spec.width}</width>
      <height>{spec.height}</height>
    </resolution>
    <effectiveBit>
      <depth>{spec.bit_depth}</depth>
      <side>{spec.effective_bit_side}</side>
    </effectiveBit>
    <colorInfo>
      <type>Mono</type>
      <bit>{spec.color_bit if spec.color_bit is not None else spec.bit_depth}</bit>
    </colorInfo>
  </imageDataInfo>
  <deviceInfo>
    <deviceName>{device_name}</deviceName>
    <recordRate>{spec.record_rate}</recordRate>
    <irig>{spec.irig}</irig>
  </deviceInfo>
</cih>"""
    return xml.encode("utf-8")


def write_cihx(path: PathLike, spec: CihxSpec, preamble_bytes: int = 64) -> Path:
    """Write a .cihx file: opaque binary preamble followed by the XML block.

    The preamble emulates the proprietary binary header real cameras emit;
    parsers must locate the XML by scanning, not by fixed offset.
    """
    path = Path(path)
    preamble = b"CIHX" + bytes(i % 256 for i in range(preamble_bytes - 4))
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(_cihx_xml(spec))
    return path


def write_cih(path: PathLike, spec: CihxSpec) -> Path:
    """Write a plain-text .cih header ('Key : Value' lines + END)."""
    path = Path(path)
    for field in ("comment", "device_name", "date", "time"):
        if "\n" in str(getattr(spec, field)):
            raise ValueError(
                f"CihxSpec.{field} contains a newline — .cih is a "
                f"line-oriented format"
            )
    lines = [
        "#Camera Information Header",
        f"Date : {spec.date}",
        f"Camera Type : {spec.device_name}",
        f"Record Rate(fps) : {spec.record_rate}",
        f"Shutter Speed(s) : {spec.shutter_speed_ns * 1e-9:.9f}",
        f"Total Frame : {spec.total_frames}",
        # Same semantics as the cihx dialect (read_cihx_header maps
        # 'Original Total Frame' from frameInfo/recordedFrame): the camera's
        # recorded count, not the saved count.
        f"Original Total Frame : {spec.recorded_frame}",
        f"Start Frame : {spec.start_frame}",
        f"Trigger Frame : {spec.trigger_frame}",
        f"Image Width : {spec.width}",
        f"Image Height : {spec.height}",
        f"File Format : {spec.file_format}",
        f"EffectiveBit Depth : {spec.bit_depth}",
        f"EffectiveBit Side : {spec.effective_bit_side}",
        f"Color Bit : {spec.color_bit if spec.color_bit is not None else spec.bit_depth}",
        f"Comment Text : {spec.comment}",
        "END",
    ]
    path.write_text("\n".join(lines) + "\n")
    return path


def _packer(bit_depth: int):
    """Native (OpenMP) packer when the codec builds, else the numpy twin.

    Both enforce the same range/shape contract; proven byte-identical in
    tests. Packing a multi-GB synthetic payload is bandwidth-bound, so the
    parallel path matters for large golden recordings.
    """
    numpy_pack = pack_12bit if bit_depth == 12 else pack_10bit
    try:
        from .._native import native_decoder

        d = native_decoder()
        return d.pack_12bit if bit_depth == 12 else d.pack_10bit
    except Exception:
        return numpy_pack


def write_mraw(path: PathLike, frames: np.ndarray, bit_depth: int = 12) -> Path:
    """Write frames (n, H, W) uint16 as a packed .mraw payload."""
    path = Path(path)
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError(f"frames must be (n, H, W), got shape {frames.shape}")
    with open(path, "wb") as f:
        if bit_depth == 8:
            f.write(frames.astype(np.uint8).tobytes())
        elif bit_depth == 16:
            f.write(frames.astype("<u2").tobytes())
        elif bit_depth in (10, 12):
            f.write(_packer(bit_depth)(frames.astype(np.uint16)).tobytes())
        else:
            raise ValueError(f"Unsupported bit depth: {bit_depth}")
    return path


def write_recording(
    directory: PathLike,
    stem: str,
    frames: np.ndarray,
    spec: Optional[CihxSpec] = None,
    metadata_format: str = "cihx",
    **spec_overrides,
) -> Path:
    """Write a full recording (metadata + payload); returns the metadata path.

    The payload packs at the STORAGE depth (``spec.color_bit`` when set,
    else ``spec.bit_depth``) — the same 'Color Bit selects the container
    decoder' contract readers follow, so a 12-effective-bits-in-16-bit-words
    recording round-trips.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    n, h, w = frames.shape
    if spec is None:
        spec = CihxSpec(width=w, height=h, total_frames=n, **spec_overrides)
    elif spec_overrides:
        raise ValueError(
            f"spec_overrides {sorted(spec_overrides)} are ignored when an "
            f"explicit spec is given — set them on the spec instead"
        )
    if (spec.total_frames, spec.height, spec.width) != (n, h, w):
        raise ValueError(
            f"spec geometry ({spec.total_frames}, {spec.height}, "
            f"{spec.width}) does not match frames {frames.shape}"
        )
    storage_depth = spec.color_bit if spec.color_bit is not None else spec.bit_depth
    write_mraw(directory / f"{stem}.mraw", frames, bit_depth=storage_depth)
    if metadata_format == "cihx":
        return write_cihx(directory / f"{stem}.cihx", spec)
    if metadata_format == "cih":
        return write_cih(directory / f"{stem}.cih", spec)
    raise ValueError(f"Unknown metadata format: {metadata_format}")


@dataclass
class FlameSpec:
    """Analytic flame-front trajectory + appearance for synthetic videos.

    position(i) = x0 + v0*i + 0.5*a*i^2 (+ v_jump*(i - ddt_frame) after DDT),
    in pixels per frame index. The rendered frame has a bright plateau from
    the left edge to position(i) with a sharp sigmoid leading edge, on top of
    a dark noisy background; first frames can be empty (pre-ignition).
    """

    x0: float = 30.0
    v0_px: float = 6.0           # px/frame before DDT
    accel_px: float = 0.0        # px/frame^2
    ddt_frame: Optional[int] = None
    v_jump_px: float = 0.0       # extra px/frame after ddt_frame
    ignition_frame: int = 2      # frames before this are background-only
    background_level: int = 40   # mean background DN
    background_noise: int = 6    # uniform noise amplitude
    flame_level: int = 3000      # plateau DN (12-bit scale)
    edge_width_px: float = 2.0   # sigmoid edge sharpness
    seed: int = 0

    def position(self, i: int) -> float:
        """Analytic leading-edge position (px) at frame i."""
        rel = i - self.ignition_frame
        if rel < 0:
            return float("nan")
        x = self.x0 + self.v0_px * rel + 0.5 * self.accel_px * rel * rel
        if self.ddt_frame is not None and i >= self.ddt_frame:
            x += self.v_jump_px * (i - self.ddt_frame)
        return x


def synthesize_flame_video(
    n_frames: int,
    height: int = 64,
    width: int = 512,
    flame: Optional[FlameSpec] = None,
    bit_depth: int = 12,
) -> tuple:
    """Render a synthetic flame recording.

    Returns (frames uint16 (n, H, W), positions float (n,)) where positions
    holds the analytic leading-edge pixel per frame (NaN pre-ignition).
    """
    if flame is None:
        flame = FlameSpec()
    rng = np.random.default_rng(flame.seed)
    max_dn = (1 << bit_depth) - 1

    xs = np.arange(width, dtype=np.float64)
    positions = np.array(
        [flame.position(i) for i in range(n_frames)], dtype=np.float64
    )

    # Vectorized integer render: one noise draw + broadcast sigmoid profiles
    # (all uint16 — no (N, H, W) float temporaries).
    frames = rng.integers(
        flame.background_level,
        flame.background_level + flame.background_noise + 1,
        size=(n_frames, height, width),
        dtype=np.uint16,
    )
    lit = np.isfinite(positions)
    if np.any(lit):
        pos_lit = positions[lit][:, None]  # (L, 1)
        profiles = flame.flame_level / (
            1.0 + np.exp((xs[None, :] - pos_lit) / max(flame.edge_width_px, 1e-3))
        )  # (L, W) float
        # Saturating add: background + flame_level above the uint16 (or
        # container) ceiling must clamp, not wrap around to darkness.
        peak = flame.flame_level + flame.background_level + flame.background_noise
        first = int(np.argmax(lit))  # lit == (i >= ignition_frame): contiguous
        if peak <= 0xFFFF and bool(lit[first:].all()):
            # Fast path: in-place uint16 broadcast add over the contiguous lit
            # tail — no int32 temporaries, no fancy-index copies (~3x less
            # memory traffic; synthesis is bandwidth-bound on big videos).
            prof_u16 = np.minimum(profiles, max_dn).astype(np.uint16)
            tail = frames[first:]
            np.add(tail, prof_u16[:, None, :], out=tail)
            np.minimum(tail, max_dn, out=tail)
        else:
            summed = (
                frames[lit].astype(np.int32)
                + profiles.astype(np.int32)[:, None, :]
            )
            frames[lit] = np.minimum(summed, max_dn).astype(np.uint16)
    np.minimum(frames, max_dn, out=frames)
    return frames, positions
