"""The plain reference: a recording's three result tables, in NumPy.

Written from the semantics of the reference pipeline
(``scripts/process_videos.py`` of Nadexterbrown/High-Speed-Image-Processing)
and imports nothing of the program. From the bytes of a CIHX + packed MRAW
recording it computes, in float64:

1. the CIHX fields (geometry, bit depth, frame rate, start and skip frame);
2. the scalar background (the first frame's maximum) and each frame's
   above-noise pixel count over the whole frame, which decides the
   empty frames;
3. on the band of rows around the centerline that the detector reads:
   scalar background subtraction, frame differencing against the previous
   frame with its threshold, grey opening, Gaussian blur, horizontal Sobel
   and ``np.gradient`` of the centerline (scipy's 'reflect' boundary; the
   band is cut so that its centre row equals the full-frame result);
4. the serial tracker: velocity-capped search windows, the combined
   (min-gradient / rightmost-Sobel) or threshold detector, the three
   velocity stencils, the DDT latch, the exit and velocity-drop stops;
5. the calibration and position offset by filename, and the three tables
   (all / pre-DDT / post-DDT) as the table writer formats them.

``precision="bfloat16"`` rounds every arithmetic result of step 3 to
bfloat16: the control that the comparison must tell apart from the
program.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["read_cihx", "calibration_for", "band_profiles",
           "reference_tables", "TABLE_KINDS", "table_suffix"]

TABLE_KINDS = ("all", "pre_ddt", "post_ddt")
_SUFFIX = {"all": "-flame-position.txt",
           "pre_ddt": "-flame-position-pre-DDT.txt",
           "post_ddt": "-flame-position-post-DDT.txt"}

# The empty-frame rule (process_videos.py:1458-1459).
MIN_SIGNAL_FRACTION = 0.0005
NOISE_THRESHOLD_FLOOR = 10.0
BLOCK_FRAMES = 256

_HEADER = (
    "# Flame Position and Velocity Data\n"
    "#\n"
    "# Velocity Extraction Methods:\n"
    "#   Vel_Backward1: First-order backward difference\n"
    "#                  v_n = (x_n - x_{n-1}) / dt\n"
    "#                  Evaluates velocity at current time step\n"
    "#\n"
    "#   Vel_Backward2: Second-order backward difference\n"
    "#                  v_n = (3*x_n - 4*x_{n-1} + x_{n-2}) / (2*dt)\n"
    "#                  Higher accuracy at current time, requires 3 points\n"
    "#\n"
    "#   Vel_Central:   Second-order central difference\n"
    "#                  v_{n-1} = (x_n - x_{n-2}) / (2*dt)\n"
    "#                  Most accurate, but evaluates at PRIOR time step\n"
    "#\n"
    "#Frame Time_s Position_px Position_m Vel_Backward1 Vel_Backward2 "
    "Vel_Central\n"
)


def table_suffix(kind: str) -> str:
    """File name suffix of a table kind (after the recording's stem)."""
    return _SUFFIX[kind]


# ---------------------------------------------------------------- metadata


def read_cihx(path) -> dict:
    """The fields of a .cihx file the tables depend on."""
    raw = Path(path).read_bytes()
    start = raw.find(b"<cih>")
    end = raw.rfind(b"</cih>")
    if start < 0 or end < 0:
        raise ValueError(f"{path}: no <cih> document")
    root = ET.fromstring(raw[start:end + len(b"</cih>")])

    def num(tag, default=None):
        node = root.find(tag)
        if node is None or node.text is None:
            if default is None:
                raise ValueError(f"{path}: no {tag}")
            return default
        return int(node.text.strip())

    depth = num("imageDataInfo/effectiveBit/depth")
    return {
        "width": num("imageDataInfo/resolution/width"),
        "height": num("imageDataInfo/resolution/height"),
        "frames": num("frameInfo/totalFrame"),
        "record_rate": num("recordInfo/recordRate"),
        "start_frame": num("frameInfo/startFrame", 0),
        "skip_frame": num("frameInfo/skipFrame", 1),
        "storage_bits": num("imageDataInfo/colorInfo/bit", depth),
    }


def calibration_for(name: str, source: dict) -> Tuple[float, float]:
    """(m per px, offset m) for a file name: the first entry with a
    matching pattern; a plain pattern matches as a substring, ``A:B``
    compares the last integer of the name with the last integers of A and
    B. No match: the source's defaults."""
    last = re.findall(r"\d+", name)
    for entry in source.get("file_calibrations", []):
        for pattern in entry["files"]:
            if ":" in pattern:
                lo, _, hi = pattern.partition(":")
                lo_n, hi_n = re.findall(r"\d+", lo), re.findall(r"\d+", hi)
                if lo_n and hi_n and last and \
                        int(lo_n[-1]) <= int(last[-1]) <= int(hi_n[-1]):
                    return float(entry["calibration"]), float(entry["position_offset"])
            elif pattern in name:
                return float(entry["calibration"]), float(entry["position_offset"])
    return float(source.get("calibration", 1.0)), float(source.get("position_offset", 0.0))


# ----------------------------------------------------------------- payload


def _frames_view(mraw: Path, meta: dict) -> np.ndarray:
    """The payload as (frames, bytes a frame) uint8."""
    h, w, bits = meta["height"], meta["width"], meta["storage_bits"]
    per_frame = {8: h * w, 12: h * w * 3 // 2, 16: h * w * 2}.get(bits)
    if per_frame is None:
        raise ValueError(f"{mraw}: {bits}-bit payloads are not supported here")
    data = np.memmap(mraw, dtype=np.uint8, mode="r")
    return data[: meta["frames"] * per_frame].reshape(meta["frames"], per_frame)


def _decode(raw: np.ndarray, bits: int) -> np.ndarray:
    """Packed bytes (..., nbytes) -> pixels (..., npix) uint16."""
    if bits == 8:
        return raw.astype(np.uint16)
    if bits == 16:
        return np.ascontiguousarray(raw).view("<u2").astype(np.uint16)
    b = raw.reshape(raw.shape[:-1] + (-1, 3)).astype(np.uint16)
    out = np.empty(b.shape[:-1] + (2,), dtype=np.uint16)
    out[..., 0] = (b[..., 0] << 4) | (b[..., 1] >> 4)
    out[..., 1] = ((b[..., 1] & 0x0F) << 8) | b[..., 2]
    return out.reshape(raw.shape[:-1] + (-1,))


def _reflect(idx: np.ndarray, n: int) -> np.ndarray:
    """scipy 'reflect' (edge value repeated) folding of indices into [0, n)."""
    idx = np.mod(idx, 2 * n)
    return np.where(idx >= n, 2 * n - 1 - idx, idx)


# ------------------------------------------------------------ band chain


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), kept as float64."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32).astype(np.float64)


def _identity(x):
    return x


def _shift_w(x: np.ndarray, offsets) -> List[np.ndarray]:
    """Views of ``x`` shifted along its last axis by each offset, with
    reflect padding."""
    w = x.shape[-1]
    lo, hi = min(offsets), max(offsets)
    pad = x[..., _reflect(np.arange(lo, w + hi), w)]
    return [pad[..., o - lo:o - lo + w] for o in offsets]


def _extremum(x: np.ndarray, k: int, op, dilation: bool) -> np.ndarray:
    """Flat k x k erosion (min) or dilation (max): reflect along width,
    valid along rows (the band loses k - 1 rows). scipy centres an even
    window left for erosion and right for dilation."""
    left = k - 1 - k // 2 if dilation else k // 2
    taps = _shift_w(x, [o - left for o in range(k)])
    out = op(taps[0], taps[1])
    for t in taps[2:]:
        op(out, t, out=out)
    rows = out.shape[-2] - k + 1
    res = op(out[..., 0:rows, :], out[..., 1:1 + rows, :])
    for o in range(2, k):
        op(res, out[..., o:o + rows, :], out=res)
    return res


def _gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


def band_margin(detector: dict) -> int:
    """Rows above and below the centerline that its result depends on."""
    k = int(detector["morphology_kernel_size"])
    radius = int(4.0 * float(detector["gaussian_sigma"]) + 0.5)
    return (k - 1) + radius + 1


def band_profiles(sub: np.ndarray, prior: np.ndarray, detector: dict,
                  precision: str = "float64"):
    """Centerline (sobel, gradient, intensity) of each frame of a band.

    ``sub`` is (n, 2*margin+1, W) background-subtracted float64, ``prior``
    the same of each frame's differencing prior. Every arithmetic result
    is rounded to ``precision`` ('float64' or 'bfloat16')."""
    q = _bf16 if precision == "bfloat16" else _identity
    k = int(detector["morphology_kernel_size"])
    if k % 2 == 0:
        raise ValueError("an even morphology kernel is not supported here")
    diff = q(sub - prior)
    diff[diff < float(detector["frame_diff_threshold"])] = 0.0
    opened = _extremum(_extremum(diff, k, np.minimum, False), k, np.maximum, True)
    taps = q(_gaussian_taps(float(detector["gaussian_sigma"])))
    r = (taps.size - 1) // 2
    rows = opened.shape[-2] - 2 * r
    vert = q(taps[0] * opened[..., 0:rows, :])
    for j in range(1, taps.size):
        vert = q(vert + q(taps[j] * opened[..., j:j + rows, :]))
    shifted = _shift_w(vert, list(range(-r, r + 1)))
    blurred = q(taps[0] * shifted[0])
    for j in range(1, taps.size):
        blurred = q(blurred + q(taps[j] * shifted[j]))
    if blurred.shape[-2] != 3:
        raise ValueError("the band does not match the detector's margin")
    left, right = _shift_w(blurred, [-1, 1])
    dx = q(right - left)
    sobel = q(q(dx[..., 0, :] + q(2.0 * dx[..., 1, :])) + dx[..., 2, :])
    c = blurred[..., 1, :]
    grad = np.empty_like(c)
    grad[..., 1:-1] = q(q(c[..., 2:] - c[..., :-2]) / 2.0)
    grad[..., 0] = q(c[..., 1] - c[..., 0])
    grad[..., -1] = q(c[..., -1] - c[..., -2])
    return sobel, grad, c


# ------------------------------------------------------------- detectors


def _combined(sobel, grad, start, end, det) -> Optional[int]:
    ss, sg = sobel[start:end], grad[start:end]
    if ss.size == 0:
        return None
    strength = float(det["min_gradient_strength"])
    found = []
    if np.min(sg) < -strength:
        found.append(start + int(np.argmin(sg)))
    mag = np.abs(ss)
    peak = np.max(mag)
    if peak > strength:
        above = np.nonzero(mag > peak * float(det["sobel_threshold_fraction"]))[0]
        if above.size:
            found.append(start + int(above[-1]))
    return max(found) if found else None


def _threshold(line, start, end, det) -> Optional[int]:
    start, end = max(0, start), min(line.size, end)
    win = line[start:end]
    if win.size == 0:
        return None
    peak = float(np.max(win))
    if peak <= float(det["min_gradient_strength"]):
        return None
    level = float(det["threshold_fraction"]) * peak
    at = int(np.argmax(win))
    mask = win[at:] >= level
    if not mask[0]:
        return None
    below = np.nonzero(~mask)[0]
    return start + at + (int(below[0]) - 1 if below.size else mask.size - 1)


# ---------------------------------------------------------------- tables


def _fmt(rows: List[tuple]) -> str:
    lines = [_HEADER]
    for f, t, px, m, v1, v2, vc in rows:
        lines.append(" ".join((
            str(f), f"{t:.9f}", str(px), f"{m:.9f}",
            f"{v1:.3f}" if v1 is not None else "",
            f"{v2:.3f}" if v2 is not None else "",
            f"{vc:.3f}" if vc is not None else "",
        )) + "\n")
    return "".join(lines)


def _track(profiles, empty, meta, cal, offset, source, det) -> Dict[str, str]:
    """The serial tracker over one recording's profiles -> table texts."""
    sobel, grad, intensity, raw_center = profiles
    rate = meta["record_rate"]
    width = meta["width"]
    method = source["detection_method"]
    diff_line = bool(source.get("use_frame_diff", True))
    if not source.get("use_absolute_time", True):
        raise ValueError("trigger-relative time is not supported here")
    margin = int(det["edge_margin_px"])
    exit_at = width - int(det["exit_margin_px"])
    max_disp = int(np.ceil(float(det["max_velocity_change_m_s"]) * (1.0 / rate) / cal)) + 1
    jump = float(det["ddt_velocity_jump_m_s"])

    hist: List[Tuple[int, Optional[int]]] = []
    vel: List[list] = []
    last_pos = last_frame = None
    ddt = None
    rows = []
    for i in range(meta["frames"]):
        if empty[i]:
            continue
        if last_pos is None:
            start, end = margin, width - margin
        else:
            start = last_pos
            end = min(width - margin, last_pos + max_disp * max(1, i - last_frame)
                      + int(det["search_window_px"]))
        pos = None
        if method == "combined":
            if i > 0:
                pos = _combined(sobel[i], grad[i], start, end, det)
        elif method == "threshold":
            if not diff_line:
                pos = _threshold(raw_center[i], start, end, det)
            elif i > 0:
                pos = _threshold(intensity[i], start, end, det)
        else:
            raise ValueError(f"detection method {method!r} is not supported here")
        hist.append((i, pos))
        if pos is not None:
            last_pos, last_frame = pos, i
            _, prev = hist[-2] if len(hist) >= 2 else (None, None)
            if len(hist) >= 2 and prev is not None:
                pf = hist[-2][0]
                dt = (i - pf) / rate
                if dt > 0:
                    v1 = (pos - prev) * cal / dt
                    v2 = vc = None
                    if len(hist) >= 3 and hist[-3][1] is not None:
                        p2 = hist[-3][1]
                        v2 = (3 * pos - 4 * prev + p2) * cal / (2 * dt)
                        vc = (pos - p2) * cal / (2 * dt)
                        if vel:
                            vel[-1][3] = vc
                    vel.append([i, v1, v2, None])
                    if ddt is None and len(vel) >= 2 and v1 - vel[-2][1] > jump:
                        ddt = i
        stop = pos is not None and pos >= exit_at
        if not stop and len(vel) >= 2:
            before, latest = vel[-2][1], vel[-1][1]
            stop = before > 100 and (before - latest) / before > 0.5
        if stop:
            if len(vel) >= 2:
                vel[-2][3] = None
            break
        if pos is not None:
            t = (meta["start_frame"] + i * meta["skip_frame"]) / rate
            rows.append((i, t, pos, pos * cal + offset, ddt is not None and i >= ddt))

    by_frame = {e[0]: (e[1], e[2], e[3]) for e in vel}
    merged = [(f, t, px, m) + by_frame.get(f, (None, None, None)) + (post,)
              for f, t, px, m, post in rows]
    tables = {}
    if merged:
        tables["all"] = _fmt([r[:7] for r in merged])
        pre = [r[:7] for r in merged if not r[7]]
        post = [r[:7] for r in merged if r[7]]
        if pre:
            tables["pre_ddt"] = _fmt(pre)
        if post:
            tables["post_ddt"] = _fmt(post)
    return tables


def reference_tables(cihx_path, source: dict, detector: dict,
                     precision: str = "float64") -> Dict[str, str]:
    """The tables one recording should produce: {kind: text}, a kind left
    out where the writer writes no file."""
    cihx_path = Path(cihx_path)
    meta = read_cihx(cihx_path)
    frames = _frames_view(cihx_path.with_suffix(".mraw"), meta)
    n, h, w, bits = meta["frames"], meta["height"], meta["width"], meta["storage_bits"]
    background = int(_decode(frames[0], bits).max())
    above = background + max(NOISE_THRESHOLD_FLOOR, background * 0.5)
    margin = band_margin(detector)
    rows = _reflect(np.arange(h // 2 - margin, h // 2 + margin + 1), h)
    row_bytes = frames.shape[1] // h

    empty = np.zeros(n, dtype=bool)
    sobel = np.zeros((n, w))
    grad = np.zeros((n, w))
    intensity = np.zeros((n, w))
    raw_center = np.zeros((n, w))
    prior = None
    for a in range(0, n, BLOCK_FRAMES):
        b = min(n, a + BLOCK_FRAMES)
        block = frames[a:b]
        counts = (_decode(block, bits) > above).sum(axis=1)
        empty[a:b] = counts / float(h * w) < MIN_SIGNAL_FRACTION
        band = block.reshape(b - a, h, row_bytes)[:, rows, :]
        sub = np.maximum(_decode(band, bits).astype(np.float64) - background, 0.0)
        if precision == "bfloat16":
            sub = _bf16(sub)
        raw_center[a:b] = sub[:, margin, :]
        prev = np.concatenate([sub[:1] if prior is None else prior, sub[:-1]])
        s, g, c = band_profiles(sub, prev, detector, precision)
        sobel[a:b], grad[a:b], intensity[a:b] = s, g, c
        prior = sub[-1:]
    cal, offset = calibration_for(cihx_path.name, source)
    return _track((sobel, grad, intensity, raw_center), empty, meta,
                  cal, offset, source, detector)
