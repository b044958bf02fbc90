"""CIHX / CIH metadata parsing for Photron high-speed camera recordings.

A Photron recording consists of a metadata file (``.cih`` plain-text or
``.cihx`` binary-header + embedded XML) plus a raw frame payload (``.mraw``).

This module parses both metadata dialects into plain dictionaries:

* :func:`parse_cihx_xml` — timing-oriented view of the embedded ``<cih>`` XML
  (record rate, trigger/start/skip frames, recording datetime, IRIG, shutter).
  Parity target: reference ``src/photron/video.py:31-150``.
* :func:`read_cih_header` / :func:`read_cihx_header` — full acquisition header
  (image geometry, bit depth, file format, ...) in the pyMRAW-style key space
  (``'Image Width'``, ``'Record Rate(fps)'``, ...) that the rest of the
  framework consumes. Parity target: the info dict returned by
  ``pyMRAW.load_video`` as consumed at reference ``src/photron/video.py:332-348``.

Everything here is host-side, metadata-only code; the hot pixel path lives in
:mod:`hsip_tpu.io.mraw` and :mod:`hsip_tpu.kernels`.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Union

__all__ = [
    "parse_cihx_xml",
    "read_cih_header",
    "read_cihx_header",
    "read_header",
    "extract_cihx_xml_bytes",
]

PathLike = Union[str, Path]

# Default timing record returned when the XML block is absent or malformed.
# Matches the reference defaults (video.py:51-60).
_DEFAULT_TIMING: Dict[str, Any] = {
    "recording_datetime": None,
    "record_rate": 0,
    "recorded_frame": 0,
    "start_frame": 0,
    "total_frame": 0,
    "skip_frame": 1,
    "irig_enabled": False,
    "shutter_speed_ns": 0,
}


def extract_cihx_xml_bytes(filepath: PathLike) -> Optional[bytes]:
    """Locate the embedded ``<cih>`` XML document inside a CIHX file.

    CIHX files carry a binary preamble followed by an XML document. The XML
    is located by scanning for ``<?xml`` (or a bare ``<cih>`` root) and ends
    at the closing ``</cih>`` tag. Returns None when no XML block exists.
    """
    with open(filepath, "rb") as f:
        content = f.read()

    xml_start = content.find(b"<?xml")
    if xml_start == -1:
        xml_start = content.find(b"<cih>")
        if xml_start == -1:
            xml_start = content.find(b"<cih ")
    if xml_start == -1:
        return None

    xml_end = content.find(b"</cih>", xml_start)
    if xml_end == -1:
        return None
    return content[xml_start : xml_end + len(b"</cih>")]


def _parse_cihx_root(filepath: PathLike) -> Optional[ET.Element]:
    """Extract and parse the embedded <cih> XML document (shared by the
    timing view and the acquisition-header view, so the two parsers of the
    same document cannot drift in how they locate/decode it)."""
    xml_bytes = extract_cihx_xml_bytes(filepath)
    if xml_bytes is None:
        return None
    return ET.fromstring(xml_bytes.decode("utf-8", errors="ignore"))


def _record_rate(root: ET.Element) -> Optional[int]:
    """recordInfo/recordRate with the deviceInfo fallback some cameras use."""
    val = _find_int(root, "recordInfo/recordRate")
    if val is None or val == 0:
        fallback = _find_int(root, "deviceInfo/recordRate")
        if fallback is not None:
            return fallback
    return val


def _find_int(root: ET.Element, path: str) -> Optional[int]:
    elem = root.find(path)
    if elem is not None and elem.text:
        try:
            return int(elem.text.strip())
        except ValueError:
            return None
    return None


def _find_text(root: ET.Element, path: str) -> Optional[str]:
    elem = root.find(path)
    if elem is not None and elem.text:
        return elem.text.strip()
    return None


def parse_cihx_xml(filepath: PathLike) -> Dict[str, Any]:
    """Parse a CIHX file's embedded XML into a timing-metadata dict.

    Returns a dict with keys ``recording_datetime``, ``record_rate``,
    ``recorded_frame``, ``start_frame``, ``total_frame``, ``skip_frame``,
    ``irig_enabled``, ``shutter_speed_ns``. On any failure a defaults dict is
    returned (with a printed warning), never an exception — the pipeline must
    degrade gracefully on corrupt metadata, matching reference
    ``video.py:146-150``.
    """
    result = dict(_DEFAULT_TIMING)

    try:
        root = _parse_cihx_root(filepath)
        if root is None:
            return result

        # fileInfo: recording date + wall-clock time.
        date_str = _find_text(root, "fileInfo/date")
        time_str = _find_text(root, "fileInfo/time")
        if date_str and time_str:
            try:
                result["recording_datetime"] = datetime.strptime(
                    f"{date_str} {time_str}", "%Y/%m/%d %H:%M:%S"
                )
            except ValueError:
                pass

        # frameInfo: frame bookkeeping relative to the trigger.
        for key, path in (
            ("recorded_frame", "frameInfo/recordedFrame"),
            ("total_frame", "frameInfo/totalFrame"),
            ("start_frame", "frameInfo/startFrame"),
            ("skip_frame", "frameInfo/skipFrame"),
        ):
            val = _find_int(root, path)
            if val is not None:
                result[key] = val

        # recordInfo: acquisition rate (with deviceInfo fallback) + shutter.
        val = _record_rate(root)
        if val is not None:
            result["record_rate"] = val
        val = _find_int(root, "recordInfo/shutterSpeedNsec")
        if val is not None:
            result["shutter_speed_ns"] = val

        # deviceInfo: IRIG flag.
        val = _find_int(root, "deviceInfo/irig")
        if val is not None:
            result["irig_enabled"] = val != 0

    except Exception as e:  # noqa: BLE001 — graceful degradation by contract
        print(f"Warning: Failed to parse CIHX XML: {e}")
        return dict(_DEFAULT_TIMING)

    return result


# ---------------------------------------------------------------------------
# Full acquisition headers (geometry + format), pyMRAW-compatible key space.
# ---------------------------------------------------------------------------

# .cih text keys are used verbatim; these are the ones we type-convert.
_CIH_INT_KEYS = {
    "Total Frame",
    "Original Total Frame",
    "Image Width",
    "Image Height",
    "EffectiveBit Depth",
    "Color Bit",
    "Record Rate(fps)",
    "Trigger Frame",
    "Start Frame",
    "Correct Trigger Frame",
}
_CIH_FLOAT_KEYS = {"Shutter Speed(s)"}


def read_cih_header(filepath: PathLike) -> Dict[str, Any]:
    """Parse a plain-text ``.cih`` header file into a metadata dict.

    The .cih dialect is ``Key : Value`` lines terminated by an ``END`` line.
    Keys follow the Photron/pyMRAW naming convention ('Record Rate(fps)',
    'Image Width', ...).
    """
    info: Dict[str, Any] = {}
    with open(filepath, "r", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if line == "END":
                break
            if ":" not in line or line.startswith("#"):
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            if key in _CIH_INT_KEYS:
                try:
                    info[key] = int(float(value))
                except ValueError:
                    # Omit rather than coerce to 0: downstream cannot tell a
                    # real 0 from garbage, and the absent-key fallbacks (frame
                    # count from file size, default bit depth) are correct.
                    print(
                        f"Warning: ignoring malformed .cih value "
                        f"{key!r} : {value!r} in {filepath}"
                    )
            elif key in _CIH_FLOAT_KEYS:
                try:
                    info[key] = float(_parse_shutter(value))
                except (ValueError, ZeroDivisionError):
                    print(
                        f"Warning: ignoring malformed .cih value "
                        f"{key!r} : {value!r} in {filepath}"
                    )
            else:
                info[key] = value
    return info


def _parse_shutter(value: str) -> float:
    """Shutter speed may appear as a plain float or a '1/N' fraction."""
    value = value.strip()
    if "/" in value:
        num, _, den = value.partition("/")
        return float(num) / float(den)
    return float(value)


def read_cihx_header(filepath: PathLike) -> Dict[str, Any]:
    """Parse a ``.cihx`` file's XML into a pyMRAW-style acquisition header.

    Extracts image geometry, bit depth, format, frame counts and rate from the
    embedded XML (``imageDataInfo``, ``frameInfo``, ``recordInfo``,
    ``deviceInfo``, ``fileInfo`` sections) and maps them into the
    'Image Width' / 'Record Rate(fps)' / ... key space used across the
    framework.
    """
    info: Dict[str, Any] = {}
    root = _parse_cihx_root(filepath)
    if root is None:
        raise ValueError(f"No <cih> XML block found in {filepath}")

    mapping_int = {
        "Image Width": "imageDataInfo/resolution/width",
        "Image Height": "imageDataInfo/resolution/height",
        "EffectiveBit Depth": "imageDataInfo/effectiveBit/depth",
        "Color Bit": "imageDataInfo/colorInfo/bit",
        "Total Frame": "frameInfo/totalFrame",
        "Original Total Frame": "frameInfo/recordedFrame",
        "Trigger Frame": "frameInfo/triggerFrame",
        "Start Frame": "frameInfo/startFrame",
    }
    for key, path in mapping_int.items():
        val = _find_int(root, path)
        if val is not None:
            info[key] = val
    rate = _record_rate(root)  # same fallback as the timing view
    if rate is not None:
        info["Record Rate(fps)"] = rate

    side = _find_text(root, "imageDataInfo/effectiveBit/side")
    if side is not None:
        info["EffectiveBit Side"] = side
    fmt = _find_text(root, "imageDataInfo/recordInfo/fileFormat") or _find_text(
        root, "fileInfo/fileFormat"
    )
    if fmt is not None:
        info["File Format"] = fmt

    shutter_ns = _find_int(root, "recordInfo/shutterSpeedNsec")
    if shutter_ns is not None:
        info["Shutter Speed(s)"] = shutter_ns * 1e-9

    device = _find_text(root, "deviceInfo/deviceName")
    if device is not None:
        info["Camera Type"] = device
    date = _find_text(root, "fileInfo/date")
    if date is not None:
        info["Date"] = date
    comment = _find_text(root, "fileInfo/comment")
    if comment is not None:
        info["Comment Text"] = comment

    return info


def read_header(filepath: PathLike) -> Dict[str, Any]:
    """Dispatch on suffix: .cihx → XML header, .cih → text header."""
    path = Path(filepath)
    suffix = path.suffix.lower()
    if suffix == ".cihx":
        return read_cihx_header(path)
    if suffix == ".cih":
        return read_cih_header(path)
    raise ValueError(f"Unsupported metadata file format: {suffix} ({filepath})")
