"""Synthetic CIHX/MRAW recordings for the benchmark: a frozen copy.

Copied from ``hsip_tpu_torch/io/synthetic.py`` so that the traffic the
benchmark generates cannot move when the program changes, and cut to what
the cells write: 12-bit packed MRAW with CIHX metadata, rendered by the
integer fast path (a contiguous lit tail under the uint16 ceiling). The
numpy 12-bit packer is copied in; the program's native packer
(byte-identical by its own contract) is not used.
``benchmarks/tests/test_bench_gen.py`` holds the bytes equal to the
program's writer for one spec.

The flame model (:func:`synthesize_flame_video`) renders a bright region
propagating left to right along the image with a sharp leading edge,
optional acceleration and a DDT-style velocity jump.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np



def pack_12bit(pixels: np.ndarray) -> np.ndarray:
    """Encode uint16 pixels (values < 4096) into MSB-first 12-bit bytes."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint16).reshape(-1)
    if pixels.size % 2:
        raise ValueError("12-bit packing requires an even pixel count")
    if pixels.size and int(pixels.max()) > 0xFFF:
        raise ValueError("12-bit packing requires pixel values < 4096")
    p = pixels.reshape(-1, 2)
    out = np.empty((p.shape[0], 3), dtype=np.uint8)
    out[:, 0] = (p[:, 0] >> 4).astype(np.uint8)
    out[:, 1] = (((p[:, 0] & 0x0F) << 4) | (p[:, 1] >> 8)).astype(np.uint8)
    out[:, 2] = (p[:, 1] & 0xFF).astype(np.uint8)
    return out.reshape(-1)


__all__ = [
    "CihxSpec",
    "write_cihx",
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
      <bit>{spec.bit_depth}</bit>
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


def write_mraw(path: PathLike, frames: np.ndarray) -> Path:
    """Write frames (n, H, W) uint16 as a packed 12-bit .mraw payload."""
    path = Path(path)
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError(f"frames must be (n, H, W), got shape {frames.shape}")
    with open(path, "wb") as f:
        f.write(pack_12bit(frames.astype(np.uint16)).tobytes())
    return path


def write_recording(directory: PathLike, stem: str, frames: np.ndarray,
                    spec: CihxSpec) -> Path:
    """Write a full recording (CIHX metadata + 12-bit payload); returns
    the metadata path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    n, h, w = frames.shape
    if spec.bit_depth != 12:
        raise ValueError(f"only 12-bit recordings are written, not {spec.bit_depth}")
    if (spec.total_frames, spec.height, spec.width) != (n, h, w):
        raise ValueError(
            f"spec geometry ({spec.total_frames}, {spec.height}, "
            f"{spec.width}) does not match frames {frames.shape}"
        )
    write_mraw(directory / f"{stem}.mraw", frames)
    return write_cihx(directory / f"{stem}.cihx", spec)


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
        peak = flame.flame_level + flame.background_level + flame.background_noise
        first = int(np.argmax(lit))  # lit == (i >= ignition_frame): contiguous
        if peak > 0xFFFF or not bool(lit[first:].all()):
            raise ValueError("the frozen writer renders a contiguous lit "
                             "tail under the uint16 ceiling only")
        # In-place uint16 broadcast add over the contiguous lit tail.
        prof_u16 = np.minimum(profiles, max_dn).astype(np.uint16)
        tail = frames[first:]
        np.add(tail, prof_u16[:, None, :], out=tail)
        np.minimum(tail, max_dn, out=tail)
    np.minimum(frames, max_dn, out=frames)
    return frames, positions
