"""The tracking-scan kernel's window-only sweep, held against the plain scan.

The CUDA kernel (``csrc/tracking_scan.cu``) visits only the columns of the
search window ``[max(s0,0), min(s1,W))``, reduces order-preserving integer
keys of the floats, and gives the threshold detector's first out-of-window
column below the level in closed form, ``max(peak_idx, min(s1, W))`` when
that is ``< W``. It runs only on a card; here its per-step detectors are
written out in numpy, column for column as the kernel visits them, and
must equal the plain version's detectors (``track/device_scan.py``) on
planted ties, ramps whose peak sits at the window's right end, and windows
that touch or pass the row's edges. The kernel's second warp rebuilds every
other field from the positions 32 frames at a time, lane-parallel; that
too is written out here and held against the plain scan.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hsip_tpu_torch.track.cuda_scan import ring_depth  # noqa: E402
from hsip_tpu_torch.track.device_scan import (  # noqa: E402
    _detect_gradient,
    _detect_half_maximum,
    _detect_threshold,
)

NEG, POS, BIG = np.float32(-3.0e38), np.float32(3.0e38), 2 ** 30
f32 = np.float32


def _key(x):
    """The kernel's fkey: an int order of non-NaN floats, -0.0 == +0.0."""
    i = np.array(f32(0.0) if x == 0 else f32(x)).view(np.int32).item()
    return i if i >= 0 else i ^ 0x7FFFFFFF


def _kernel_profile_edge(row, s0, s1, fraction, min_intensity, half_max):
    w = row.size
    lo, hi = max(s0, 0), min(s1, w)
    pk, pidx = _key(NEG), BIG
    for c in range(lo, hi):  # per lane: strictly greater keeps the first
        if _key(row[c]) > pk:
            pk, pidx = _key(row[c]), c
    peak = np.array(pk if pk >= 0 else pk ^ 0x7FFFFFFF, np.int32).view(np.float32).item()
    level = f32(fraction) * f32(peak)
    first_below = BIG
    for c in range(max(lo, pidx), hi):
        below = row[c] < level if half_max else not row[c] >= level
        if below:
            first_below = c
            break
    if not half_max:
        outside = max(pidx, hi)  # the closed form
        if outside < w:
            first_below = min(first_below, outside)
    window_end = hi - 1 if hi > lo else -1
    edge = window_end if first_below > window_end else first_below - 1
    return edge if (f32(peak) > f32(min_intensity) and edge >= pidx) else -1


def _kernel_gradient(row, s0, s1, min_strength):
    w = row.size

    def two_sum(a, b):
        s = f32(a + b)
        bp = f32(s - a)
        return s, f32(f32(a - f32(s - bp)) + f32(b - bp))

    def at(i):
        return row[min(max(i, 0), w - 1)]

    left = two_sum(at(s0 + 1), -at(s0))
    right = two_sum(at(s1 - 1), -at(s1 - 2))
    best = (_key(POS), _key(POS), BIG)
    for c in range(max(s0, 0), min(s1, w)):
        g = two_sum(row[min(c + 1, w - 1)], -row[max(c - 1, 0)])
        g = (f32(g[0] * f32(0.5)), f32(g[1] * f32(0.5)))
        if c == s0:
            g = left
        if c == s1 - 1:
            g = right
        best = min(best, (_key(g[0]), _key(g[1]), c))
    m_hi = np.array(best[0] if best[0] >= 0 else best[0] ^ 0x7FFFFFFF, np.int32).view(np.float32)
    m_lo = np.array(best[1] if best[1] >= 0 else best[1] ^ 0x7FFFFFFF, np.int32).view(np.float32)
    t = -f32(min_strength)
    lt_t = m_hi < t or (m_hi == t and m_lo < 0)
    lt_0 = m_hi < 0 or (m_hi == 0 and m_lo < 0)
    return best[2] if (lt_t and lt_0 and s1 - s0 >= 2) else -1


def _rows(rng, n, w, kind):
    """Integer-valued rows: planted ties and flat peaks ('ties'), or ramps
    rising to the right with plateaus, so every window's peak is at its
    right end ('ramp')."""
    if kind == "ties":
        rows = np.abs(np.round(rng.normal(40, 30, (n, w)))).astype(np.float32)
        for r in rows:
            a = rng.integers(0, w - 4)
            r[a:a + 4] = r.max()
            r[rng.integers(0, w)] = r.max()
        return rows
    steps = rng.integers(0, 3, (n, w))
    steps[:, ::7] = 0  # plateaus: ties at the top of a window
    return np.cumsum(steps, axis=1).astype(np.float32) + 5.0


def _bounds(rng, n, w):
    """Windows inside the row, touching either edge, past either edge
    (negative s0, s1 > W), a single column, and empty."""
    s0 = rng.integers(-5, w, n)
    s1 = s0 + rng.integers(0, w // 2, n)
    s0[:6] = [0, 3, -4, w - 1, 10, w - 10]
    s1[:6] = [w, w, w + 6, w, 11, w - 10]
    return s0.astype(np.int32), s1.astype(np.int32)


@pytest.mark.parametrize("kind", ["ties", "ramp"])
@pytest.mark.parametrize("method", ["threshold", "half_maximum"])
def test_window_sweep_profile_edge_equals_plain(method, kind):
    rng = np.random.default_rng(17 if method == "threshold" else 19)
    n, w = 300, 96
    rows = _rows(rng, n, w, kind)
    s0, s1 = _bounds(rng, n, w)
    cols = torch.arange(w, dtype=torch.int32)[None]
    in_window = (cols >= torch.from_numpy(s0)[:, None]) & (cols < torch.from_numpy(s1)[:, None])
    frac, mg = torch.tensor(f32(0.5)), torch.tensor(f32(10.0))
    plain = (_detect_threshold if method == "threshold" else _detect_half_maximum)(
        torch.from_numpy(rows), in_window, cols, frac, mg).numpy()
    got = [_kernel_profile_edge(rows[i], int(s0[i]), int(s1[i]), 0.5, 10.0,
                                method == "half_maximum") for i in range(n)]
    np.testing.assert_array_equal(np.array(got), plain)
    if kind == "ramp":
        # The closed form decides: the peak sits at the window's right end.
        assert sum(e >= 0 and e == min(s1[i], w) - 1 for i, e in enumerate(got)) > n // 4


def test_window_sweep_gradient_equals_plain():
    rng = np.random.default_rng(23)
    n, w = 300, 96
    rows = np.round(rng.normal(0, 15, (n, w))).astype(np.float32)
    rows[::3] = np.cumsum(rng.integers(-4, 2, (n // 3, w)), axis=1).astype(np.float32)
    s0, s1 = _bounds(rng, n, w)
    cols = torch.arange(w, dtype=torch.int32)[None]
    s0_t, s1_t = torch.from_numpy(s0), torch.from_numpy(s1)
    in_window = (cols >= s0_t[:, None]) & (cols < s1_t[:, None])
    plain = _detect_gradient(torch.from_numpy(rows), in_window, cols, s0_t, s1_t,
                             torch.tensor(f32(10.0))).numpy()
    got = [_kernel_gradient(rows[i], int(s0[i]), int(s1[i]), 10.0) for i in range(n)]
    np.testing.assert_array_equal(np.array(got), plain)


def test_float_keys_order_as_floats():
    rng = np.random.default_rng(29)
    vals = np.concatenate([rng.normal(0, 1e3, 200), [0.0, -0.0, 3e38, -3e38, 1e-40, -1e-40]])
    vals = vals.astype(np.float32)
    for a in vals[::7]:
        for b in vals:
            assert (_key(a) < _key(b)) == (a < b)
            assert (_key(a) == _key(b)) == (a == b)


@pytest.mark.cuda
@pytest.mark.parametrize("method,width,depth", [
    ("combined", 1024, 8), ("threshold", 1024, 8), ("combined", 4096, 2),
    ("gradient", 8000, 2), ("threshold", 28000, 1), ("combined", 15000, 0),
    ("threshold", 58000, 0),
])
def test_ring_depth(method, width, depth):
    """The ring the launcher picks: two groups of 8, 4, 2 or 1 frames of
    rows within a block's 227 KB of shared memory, 0 (the wrapper raises)
    past that. The depth is the built library's own choice, so this runs
    only where the kernels build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the depth comes from the built kernel library")
    assert ring_depth(method, width) == depth


# ---- the kernel's bookkeeping warp: 32 frames at a time ----


def _last(mask):
    """Highest set lane of a boolean lane mask, -1 for none (31 - clz)."""
    idx = np.flatnonzero(mask)
    return int(idx[-1]) if idx.size else -1


def _kernel_bookkeeping(final_pos, frame_indices, empty, width, cal, fr, md,
                        edge_margin, search_window, exit_margin, ddt_jump):
    """The bookkeeping warp of one video, lane for lane: each 32-frame chunk
    finds every frame's state by ballots over the lanes below it and
    shuffles from the lane that set it, and carries the chunk's last state.
    float32 throughout, one rounding an operation (as -fmad=false builds)."""
    m = final_pos.size
    cal, fr = f32(cal), f32(fr)
    lv_pos, lv_frame, p1_frame, p1_pos = -1, 0, 0, -1
    v_latest = v_prev = f32(0.0)
    n_entries, ddt = 0, -1
    stopped, stop_step, stop_reason, clear_vc = False, -1, 0, -1
    out = {k: np.zeros(m, np.int32) for k in ("s0", "s1", "recorded", "is_post")}
    lanes = np.arange(32)
    for base in range(0, m, 32):
        n = min(32, m - base)
        valid = lanes < n
        frame = np.zeros(32, np.int64)
        frame[:n] = frame_indices[base:base + n]
        active = valid & ~np.pad(empty[base:base + n], (0, 32 - n), constant_values=True)
        fp = np.full(32, -1, np.int64)
        fp[:n] = final_pos[base:base + n]
        detected = fp >= 0
        lane_state = []
        for lane in range(n):
            below = lanes < lane
            upto = lanes <= lane
            ld = _last(detected & below)
            h_pos = fp[ld] if ld >= 0 else lv_pos
            h_frame = frame[ld] if ld >= 0 else lv_frame
            no_hist = h_pos < 0
            elapsed = max(1, frame[lane] - h_frame)
            s0 = edge_margin if no_hist else h_pos
            reach = (h_pos + md * elapsed + search_window + 2 ** 31) % 2 ** 32 - 2 ** 31
            s1 = width - edge_margin if no_hist else min(width - edge_margin, reach)
            la = _last(active & below)
            q_frame = frame[la] if la >= 0 else p1_frame
            q_pos = fp[la] if la >= 0 else p1_pos
            lane_state.append((s0, s1, h_pos, h_frame, q_frame, q_pos))
        vel_ok = np.zeros(32, bool)
        v1 = np.zeros(32, np.float32)
        for lane in range(n):
            q_frame, q_pos = lane_state[lane][4:]
            if detected[lane] and q_pos >= 0 and fr > 0:
                dt = f32(f32(frame[lane] - q_frame) / fr)
                vel_ok[lane] = dt > 0
                if vel_ok[lane]:
                    v1[lane] = f32(f32(f32(fp[lane] - q_pos) * cal) / dt)
        ddt_cand = np.zeros(32, bool)
        per_lane = []
        for lane in range(n):
            below, upto = lanes < lane, lanes <= lane
            nn = n_entries + int((vel_ok & upto).sum())
            n_before = n_entries + int((vel_ok & below).sum())
            l1 = _last(vel_ok & upto)
            rest = vel_ok & upto
            if l1 >= 0:
                rest = rest.copy()
                rest[l1] = False
            l2 = _last(rest)
            lb = _last(vel_ok & below)
            nv_latest = v1[l1] if l1 >= 0 else v_latest
            nv_prev = v1[l2] if l2 >= 0 else (v_latest if l1 >= 0 else v_prev)
            v_before = v1[lb] if lb >= 0 else v_latest
            ddt_cand[lane] = vel_ok[lane] and n_before >= 1 and \
                f32(v1[lane] - v_before) > f32(ddt_jump)
            per_lane.append((nn, nv_latest, nv_prev))
        first_ddt = _last(ddt_cand[::-1])  # lowest set lane, counted from the top
        first_ddt = 31 - first_ddt if first_ddt >= 0 else -1
        stop_now = np.zeros(32, bool)
        exit_hit = np.zeros(32, bool)
        for lane in range(n):
            nn, nv_latest, nv_prev = per_lane[lane]
            exit_hit[lane] = detected[lane] and fp[lane] >= width - exit_margin
            vdrop = False
            if active[lane] and not exit_hit[lane] and nn >= 2 and nv_prev > 100:
                vdrop = f32(f32(nv_prev - nv_latest) / nv_prev) > f32(0.5)
            stop_now[lane] = exit_hit[lane] or vdrop
        if not stopped and stop_now.any():
            first = int(np.flatnonzero(stop_now)[0])
            stop_step, stop_reason = base + first, 1 if exit_hit[first] else 2
            if per_lane[first][0] >= 2:
                clear_vc = per_lane[first][0] - 2
            stopped = True
        for lane in range(n):
            nddt = ddt if ddt >= 0 else (frame[first_ddt] if 0 <= first_ddt <= lane else -1)
            o = base + lane
            out["s0"][o], out["s1"][o] = lane_state[lane][:2]
            out["recorded"][o] = detected[lane] and not stop_now[lane]
            out["is_post"][o] = nddt >= 0 and frame[lane] >= nddt
            per_lane[lane] = per_lane[lane] + (nddt,)
        last = n - 1
        s0, s1, h_pos, h_frame, q_frame, q_pos = lane_state[last]
        lv_pos, lv_frame = (fp[last], frame[last]) if detected[last] else (h_pos, h_frame)
        p1_frame, p1_pos = (frame[last], fp[last]) if active[last] else (q_frame, q_pos)
        n_entries, v_latest, v_prev, ddt = per_lane[last]
    return out, (stop_step, stop_reason, ddt, clear_vc)


def _trajectory_profiles(rng, m, w):
    """Gradient lines with one planted minimum a frame on a scripted front:
    steady, a jump (the DDT latch), a stall (the velocity-drop latch), then
    a run into the exit margin; empty frames and frame-index gaps."""
    x, xs = 30.0, []
    for j in range(m):
        step = 2.0 if j < m // 3 else (9.0 if j < m // 2 else (0.5 if j < 2 * m // 3 else 6.0))
        x = min(w - 3.0, x + step * rng.uniform(0.6, 1.4))
        xs.append(int(x))
    grad = np.round(rng.normal(0, 4, (1, m, w))).astype(np.float32)
    sob = np.zeros((1, m, w), np.float32)
    for j, xj in enumerate(xs):
        grad[0, j, xj] = -150.0
    fidx = np.cumsum(rng.integers(1, 3, m)).astype(np.int32)[None]
    empty = (rng.random(m) < 0.08)[None]
    prior = np.ones((1, m), bool)
    prior[0, 0] = False
    return fidx, sob, grad, empty, prior


@pytest.mark.parametrize("m", [200, 301, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bookkeeping_warp_equals_plain(m, seed):
    """Given the plain scan's positions, the bookkeeping warp's chunked
    reconstruction gives every other field of the plain scan: the search
    bounds, the recorded and post-DDT flags and the four latches."""
    from hsip_tpu_torch.track.device_scan import tracking_scan_plain

    rng = np.random.default_rng(100 + seed)
    w = int(4.4 * m) + 40  # the front reaches the exit margin near the end
    fidx, sob, grad, empty, prior = _trajectory_profiles(rng, m, w)
    params = dict(width=w, min_gradient_strength=10.0, sobel_threshold_fraction=0.3,
                  ddt_velocity_jump=f32(150.0), calibration=f32(0.05),
                  frame_rate=f32(1000.0), max_displacement_px=12, edge_margin_px=5,
                  search_window_px=20, exit_margin_px=15)
    res = tracking_scan_plain(*(torch.from_numpy(x) for x in (fidx, sob, grad, empty, prior)),
                              **params)
    final = res.final_position.numpy()[0]
    out, latches = _kernel_bookkeeping(
        final, fidx[0], empty[0], w, params["calibration"], params["frame_rate"],
        params["max_displacement_px"], params["edge_margin_px"],
        params["search_window_px"], params["exit_margin_px"], params["ddt_velocity_jump"])
    np.testing.assert_array_equal(out["s0"], res.search_start.numpy()[0])
    np.testing.assert_array_equal(out["s1"], res.search_end.numpy()[0])
    np.testing.assert_array_equal(out["recorded"], res.recorded.numpy()[0])
    np.testing.assert_array_equal(out["is_post"], res.is_post_ddt.numpy()[0])
    want = tuple(int(t[0]) for t in (res.stop_step, res.stop_reason, res.ddt_frame,
                                     res.clear_vc_entry))
    assert latches == want
    # The scripted front reaches every latch the warp reconstructs.
    assert (final >= 0).sum() > m // 2
    assert latches[0] >= 0 and latches[2] >= 0 and latches[3] >= 0
