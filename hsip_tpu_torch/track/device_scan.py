"""The tracker state machine on the device, in plain PyTorch.

Counterpart of :func:`hsip_tpu.track.device_scan.device_tracking_scan`,
batched over videos: :func:`tracking_scan_plain` runs the same step
operation for operation (search bounds, the four detectors with the
gradient detector's TwoSum double-float compare, history, the f32 v1, the
DDT latch and the advisory exit / velocity-drop latches) as a loop over
frames, vectorised over the video axis. It is the plain version of the
CUDA kernel in :mod:`.cuda_scan` and the scan's CPU path.

Only ``final_position`` feeds the result tables; everything else is an
advisory f32 latch kept for kernel-against-plain comparisons (see
:class:`DeviceScanResult`). The scan never stops early.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["DeviceScanResult", "tracking_scan_plain", "METHODS"]

_NEG = float(np.float32(-3.0e38))
_POS = float(np.float32(3.0e38))
_BIG_I = 2 ** 30

#: Detector names; the index is the method code the CUDA kernel takes.
METHODS = ("combined", "threshold", "half_maximum", "gradient")


class DeviceScanResult(NamedTuple):
    """Scan outputs: per-frame fields (V, M), per-video latches (V,).

    Only ``final_position`` feeds the tables; truncation, DDT and row
    labels are recomputed in float64 on the host
    (``build_device_scan_output``). The rest is advisory: an f32 v1 can sit
    on the other side of the strict ``prev_v1 > 100`` gate than float64.
    """

    final_position: torch.Tensor   # int32, -1 = no detection
    recorded: torch.Tensor         # bool — advisory (f32 stop gate)
    is_post_ddt: torch.Tensor      # bool — advisory (f32 DDT latch)
    search_start: torch.Tensor     # int32
    search_end: torch.Tensor       # int32
    stop_step: torch.Tensor        # int32, -1 = none latched; advisory
    stop_reason: torch.Tensor      # int32: 0/1 exit/2 vdrop; advisory
    ddt_frame: torch.Tensor        # int32, -1 = none; advisory
    clear_vc_entry: torch.Tensor   # int32: velocity-entry ordinal at the
                                   # first advisory stop (-1 none)


def _two_sum(a, b):
    """Knuth TwoSum: (s, e) with s + e == a + b EXACTLY (s = fl(a+b))."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _first_col(mask, cols):
    """Smallest column where ``mask`` holds, per row (2**30 when none)."""
    return torch.where(mask, cols, _BIG_I).amin(dim=1)


def _detect_threshold(prof, in_window, cols, fraction, min_intensity):
    masked = torch.where(in_window, prof, _NEG)
    peak = masked.amax(dim=1)
    peak_idx = _first_col(masked == peak[:, None], cols)
    thr = fraction * peak
    below = torch.logical_not(in_window & (prof >= thr[:, None]))
    first_below = _first_col((cols >= peak_idx[:, None]) & below, cols)
    window_end = torch.where(in_window, cols, -1).amax(dim=1)
    edge = torch.where(first_below > window_end, window_end, first_below - 1)
    ok = (peak > min_intensity) & (edge >= peak_idx)
    return torch.where(ok, edge, -1)


def _detect_half_maximum(prof, in_window, cols, fraction, min_intensity):
    masked = torch.where(in_window, prof, _NEG)
    peak = masked.amax(dim=1)
    peak_idx = _first_col(masked == peak[:, None], cols)
    level = fraction * peak
    below = in_window & (cols >= peak_idx[:, None]) & (prof < level[:, None])
    first_below = _first_col(below, cols)
    window_end = torch.where(in_window, cols, -1).amax(dim=1)
    edge = torch.where(first_below > window_end, window_end, first_below - 1)
    ok = (peak > min_intensity) & (edge >= peak_idx)
    return torch.where(ok, edge, -1)


def _detect_gradient(prof, in_window, cols, s0, s1, min_strength):
    """Steepest drop of the windowed profile, one-sided at the window edges,
    with exact double-float (hi, lo) differences and a lexicographic argmin
    (bit-equivalent to the host's float64 np.gradient of the window)."""
    w = prof.shape[1]
    left = torch.cat([prof[:, :1], prof[:, :-1]], dim=1)
    right = torch.cat([prof[:, 1:], prof[:, -1:]], dim=1)
    c_hi, c_lo = _two_sum(right, -left)
    c_hi, c_lo = c_hi * 0.5, c_lo * 0.5  # *0.5 is exact

    def at(idx):
        return prof.gather(1, idx.clamp(0, w - 1).long()[:, None])

    l_hi, l_lo = _two_sum(at(s0 + 1), -at(s0))
    r_hi, r_lo = _two_sum(at(s1 - 1), -at(s1 - 2))
    at_s0 = cols == s0[:, None]
    at_end = cols == (s1 - 1)[:, None]
    g_hi = torch.where(at_s0, l_hi, c_hi)
    g_lo = torch.where(at_s0, l_lo, c_lo)
    g_hi = torch.where(at_end, r_hi, g_hi)
    g_lo = torch.where(at_end, r_lo, g_lo)
    g_hi = torch.where(in_window, g_hi, _POS)
    g_lo = torch.where(in_window, g_lo, _POS)

    m_hi = g_hi.amin(dim=1)
    tie = g_hi == m_hi[:, None]
    m_lo = torch.where(tie, g_lo, _POS).amin(dim=1)
    pos = _first_col(tie & (g_lo == m_lo[:, None]), cols)

    def _lt(threshold):
        # f64 value (hi + lo) < T, with |lo| <= ulp(hi)/2 and T exactly f32.
        return (m_hi < threshold) | ((m_hi == threshold) & (m_lo < 0))

    ok = _lt(-min_strength) & _lt(0.0) & (s1 - s0 >= 2)
    return torch.where(ok, pos, -1)


def _per_video(x, v, dtype, device):
    """A scalar or (V,) parameter as a (V,) tensor."""
    t = torch.as_tensor(np.asarray(x, dtype=dtype)).reshape(-1).to(device)
    return t.expand(v).contiguous() if t.numel() == 1 else t


def tracking_scan_plain(
    frame_indices: torch.Tensor,              # (V, M) int32
    sobel_lines: Optional[torch.Tensor],      # (V, M, W) f32 ('combined')
    gradient_lines: Optional[torch.Tensor],   # (V, M, W) f32 ('combined')
    empty: torch.Tensor,                      # (V, M) bool
    has_prior: torch.Tensor,                  # (V, M) bool
    width: int,
    min_gradient_strength,
    sobel_threshold_fraction,
    ddt_velocity_jump,
    calibration,                              # (V,) or scalar, f32
    frame_rate,                               # (V,) or scalar, f32
    max_displacement_px=3,                    # (V,) or scalar, i32
    edge_margin_px: int = 10,
    search_window_px: int = 100,
    exit_margin_px: int = 15,
    method: str = "combined",
    intensity_lines: Optional[torch.Tensor] = None,  # (V, M, W) named methods
    method_fraction=0.5,
) -> DeviceScanResult:
    """Run the tracker over V videos of M frames each, on the tensors'
    device, in float32/int32 exactly as ``device_tracking_scan`` does.

    ``method`` selects the detector: 'combined' reads the sobel/gradient
    lines; the named methods read ``intensity_lines`` and ignore the
    sobel/gradient arguments (which may be None).
    """
    if method not in METHODS:
        raise ValueError(f"Unknown detection method: {method!r}")
    prof = sobel_lines if method == "combined" else intensity_lines
    if prof is None:
        raise ValueError(f"method {method!r} requires "
                         f"{'sobel_lines' if method == 'combined' else 'intensity_lines'}")
    v, m, w = prof.shape
    if w != width:
        raise ValueError(f"width {width} != profile width {w}")
    width, edge_margin_px = int(width), int(edge_margin_px)
    search_window_px, exit_margin_px = int(search_window_px), int(exit_margin_px)
    dev = prof.device
    f32, i32 = torch.float32, torch.int32
    cols = torch.arange(w, dtype=i32, device=dev)[None, :]
    mg = torch.tensor(np.float32(min_gradient_strength), device=dev)
    sfrac = torch.tensor(np.float32(sobel_threshold_fraction), device=dev)
    ddt_jump = torch.tensor(np.float32(ddt_velocity_jump), device=dev)
    mfrac = torch.tensor(np.float32(method_fraction), device=dev)
    cal = _per_video(calibration, v, np.float32, dev)
    fr = _per_video(frame_rate, v, np.float32, dev)
    md = _per_video(max_displacement_px, v, np.int32, dev)
    frame_indices = frame_indices.to(device=dev, dtype=i32)
    empty = empty.to(device=dev, dtype=torch.bool)
    has_prior = has_prior.to(device=dev, dtype=torch.bool)

    def full(val, dtype):
        return torch.full((v,), val, dtype=dtype, device=dev)

    lv_pos, lv_frame = full(-1, i32), full(0, i32)
    p1_frame, p1_pos = full(0, i32), full(-1, i32)
    v_latest, v_latest_ok = full(0.0, f32), full(False, torch.bool)
    v_prev, v_prev_ok = full(0.0, f32), full(False, torch.bool)
    n_entries, ddt = full(0, i32), full(-1, i32)
    stopped = full(False, torch.bool)
    stop_step, stop_reason, clear_vc = full(-1, i32), full(0, i32), full(-1, i32)

    out_final = torch.empty((v, m), dtype=i32, device=dev)
    out_rec = torch.empty((v, m), dtype=torch.bool, device=dev)
    out_post = torch.empty((v, m), dtype=torch.bool, device=dev)
    out_s0 = torch.empty((v, m), dtype=i32, device=dev)
    out_s1 = torch.empty((v, m), dtype=i32, device=dev)

    for j in range(m):
        frame = frame_indices[:, j]
        active = torch.logical_not(empty[:, j])
        prior_ok = has_prior[:, j]

        # ---- search bounds (velocity-constrained, monotone rightward) ----
        no_hist = lv_pos < 0
        frames_elapsed = torch.clamp_min(frame - lv_frame, 1)
        s0 = torch.where(no_hist, edge_margin_px, lv_pos)
        s1 = torch.where(
            no_hist,
            width - edge_margin_px,
            torch.clamp_max(
                lv_pos + md * frames_elapsed + search_window_px,
                width - edge_margin_px,
            ),
        )
        in_window = (cols >= s0[:, None]) & (cols < s1[:, None])
        window_nonempty = s1 > s0

        # ---- candidates ----
        if method == "combined":
            sob = sobel_lines[:, j]
            grad = gradient_lines[:, j]
            grad_m = torch.where(in_window, grad, _POS)
            gmin = grad_m.amin(dim=1)
            pos_g = _first_col(grad_m == gmin[:, None], cols)
            g_ok = window_nonempty & (gmin < -mg)

            abs_sob = torch.where(in_window, sob.abs(), _NEG)
            smax = abs_sob.amax(dim=1)
            above = in_window & (abs_sob > (smax * sfrac)[:, None])
            pos_s = torch.where(above, cols, -1).amax(dim=1)
            s_ok = window_nonempty & (smax > mg) & (pos_s >= 0)

            final = torch.maximum(
                torch.where(g_ok, pos_g, -1), torch.where(s_ok, pos_s, -1)
            )
        elif method == "threshold":
            final = _detect_threshold(intensity_lines[:, j], in_window, cols,
                                      mfrac, mg)
        elif method == "half_maximum":
            final = _detect_half_maximum(intensity_lines[:, j], in_window,
                                         cols, mfrac, mg)
        else:
            final = _detect_gradient(intensity_lines[:, j], in_window, cols,
                                     s0, s1, mg)
        final = torch.where(window_nonempty, final, -1)
        final = torch.where(active & prior_ok, final, -1)
        detected = active & (final >= 0)

        # ---- history append (every active step) ----
        new_p1_frame = torch.where(active, frame, p1_frame)
        new_p1_pos = torch.where(active, final, p1_pos)
        new_lv_pos = torch.where(detected, final, lv_pos)
        new_lv_frame = torch.where(detected, frame, lv_frame)

        # ---- velocities (mirror FlameTracker._update_velocities) ----
        have_prev_entry = active & (p1_pos >= 0) & detected
        dt = (frame - p1_frame).to(f32) / fr
        vel_ok = have_prev_entry & (dt > 0) & (fr > 0)
        v1 = torch.where(vel_ok, (final - p1_pos).to(f32) * cal / dt, 0.0)
        new_v_prev = torch.where(vel_ok, v_latest, v_prev)
        new_v_prev_ok = torch.where(vel_ok, v_latest_ok, v_prev_ok)
        new_v_latest = torch.where(vel_ok, v1, v_latest)
        new_v_latest_ok = vel_ok | v_latest_ok
        new_n_entries = n_entries + vel_ok.to(i32)

        # ---- DDT latch (first v1 jump above threshold) ----
        ddt_hit = vel_ok & (ddt < 0) & v_latest_ok & (v1 - v_latest > ddt_jump)
        new_ddt = torch.where(ddt_hit, frame, ddt)

        # ---- exit / velocity-drop (advisory latches) ----
        exit_hit = detected & (final >= width - exit_margin_px)
        vel_now_ok = new_v_latest_ok & (new_n_entries >= 1)
        prev_ok = new_v_prev_ok & (new_n_entries >= 2)
        vdrop_hit = (
            active
            & torch.logical_not(exit_hit)
            & vel_now_ok
            & prev_ok
            & (new_v_prev > 100.0)
            & ((new_v_prev - new_v_latest) / new_v_prev > 0.5)
        )
        stopped_now = exit_hit | vdrop_hit
        first_stop = stopped_now & torch.logical_not(stopped)
        clear_vc = torch.where(first_stop & (new_n_entries >= 2),
                               new_n_entries - 2, clear_vc)

        out_final[:, j] = final
        out_rec[:, j] = detected & torch.logical_not(stopped_now)
        out_post[:, j] = (new_ddt >= 0) & (frame >= new_ddt)
        out_s0[:, j] = s0
        out_s1[:, j] = s1

        stop_step = torch.where(first_stop, j, stop_step)
        stop_reason = torch.where(
            first_stop, torch.where(exit_hit, 1, 2).to(i32), stop_reason
        )
        stopped = stopped | stopped_now
        lv_pos, lv_frame = new_lv_pos, new_lv_frame
        p1_frame, p1_pos = new_p1_frame, new_p1_pos
        v_latest, v_latest_ok = new_v_latest, new_v_latest_ok
        v_prev, v_prev_ok = new_v_prev, new_v_prev_ok
        n_entries, ddt = new_n_entries, new_ddt

    return DeviceScanResult(
        final_position=out_final,
        recorded=out_rec,
        is_post_ddt=out_post,
        search_start=out_s0,
        search_end=out_s1,
        stop_step=stop_step,
        stop_reason=stop_reason,
        ddt_frame=ddt,
        clear_vc_entry=clear_vc,
    )
