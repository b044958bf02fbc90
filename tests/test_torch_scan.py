"""The port's tracking scan against the JAX package's device scans.

``tracking_scan_plain`` (the plain version of the CUDA scan kernel, and the
scan's CPU path) must equal ``device_tracking_scan`` and
``pallas_tracking_scan`` (interpret mode) in all nine output fields, for
all four detectors, on random profiles with planted ties and on the
profiles of synthetic flames. The exactness traps of the JAX package's
own device-scan tests are pinned here for the port too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording  # noqa: E402
from hsip_tpu.track import FlameDetectorConfig  # noqa: E402
from hsip_tpu.track.device_scan import device_tracking_scan  # noqa: E402
from hsip_tpu.track.pallas_scan import pallas_tracking_scan  # noqa: E402
from hsip_tpu.track.scan import (  # noqa: E402
    MIN_SIGNAL_FRACTION,
    FrameProfiles,
    compute_profiles_batched,
    run_tracking_scan,
)
from hsip_tpu.track.tracker import FlameTracker  # noqa: E402
from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan  # noqa: E402
from hsip_tpu_torch.track.device_scan import (  # noqa: E402
    _detect_gradient,
    tracking_scan_plain,
)
from hsip_tpu_torch.track.scan import (  # noqa: E402
    profiles_to_torch,
    run_tracking_scan_device,
    scan_params,
    track_video,
)

METHODS = ["combined", "threshold", "half_maximum", "gradient"]


def _port_scan(fidx, sob, grad, intens, empty, prior, width, params):
    """The port's plain scan on one video, fields squeezed to the JAX shapes."""
    def t(x):
        return None if x is None else torch.from_numpy(np.asarray(x))[None]

    res = tracking_scan_plain(
        t(np.asarray(fidx, np.int32)), t(sob), t(grad),
        t(np.asarray(empty, bool)), t(np.asarray(prior, bool)),
        width=width, intensity_lines=t(intens), **params,
    )
    return type(res)(*(f[0] for f in res))


def _assert_identical(port, ref):
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))
        got = getattr(port, name).numpy().astype(want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def _check_all(fidx, sob, grad, intens, empty, prior, width, params):
    """Port == lax.scan == Pallas (interpret) on all nine fields."""
    port = _port_scan(fidx, sob, grad, intens, empty, prior, width, params)
    args = (np.asarray(fidx, np.int32), sob, grad, jnp.asarray(empty),
            jnp.asarray(prior))
    kw = dict(width=width, intensity_lines=intens, **params)
    ref = device_tracking_scan(*args, **kw)
    _assert_identical(port, ref)
    pallas = pallas_tracking_scan(*args, interpret=True, **kw)
    _assert_identical(port, pallas)
    return port


def _planted_profiles(rng, m, w):
    """Integer-valued profiles with planted ties: equal gradient minima,
    equal |sobel| maxima and flat plateaus at the window peak."""
    sob = np.round(rng.normal(0, 30, (m, w))).astype(np.float32)
    grad = np.round(rng.normal(0, 15, (m, w))).astype(np.float32)
    intens = np.abs(np.round(rng.normal(40, 30, (m, w)))).astype(np.float32)
    for j in range(m):
        a, b = sorted(rng.choice(np.arange(12, w - 12), 2, replace=False))
        grad[j, a] = grad[j, b] = -80.0
        sob[j, a] = -sob[j, b] if sob[j, b] else 90.0
        intens[j, a:a + 4] = intens[j].max()
    return sob, grad, intens


@pytest.mark.parametrize("method", METHODS)
def test_plain_scan_matches_jax_scans_random(method):
    rng = np.random.default_rng(METHODS.index(method))
    for w in (256, 250):
        m = 48
        sob, grad, intens = _planted_profiles(rng, m, w)
        empty = rng.random(m) < 0.15
        prior = np.ones(m, bool)
        prior[0] = False
        fidx = np.cumsum(rng.integers(1, 3, m)).astype(np.int32)  # gaps
        params = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, method)
        _check_all(fidx, sob, grad, intens, empty, prior, w, params)


def _flame_profiles(flame, n=40, width=256, height=32):
    frames, _ = synthesize_flame_video(n, height=height, width=width, flame=flame)
    config = FlameDetectorConfig()
    p = compute_profiles_batched(
        lambda a, b: frames[a:b], n, (height, width), float(frames[0].max()),
        config, chunk_size=16, use_pallas=False,
    )
    empty = p.signal_counts / p.total_pixels < MIN_SIGNAL_FRACTION
    return p, empty


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("flame", [
    FlameSpec(x0=25.0, v0_px=9.0, accel_px=0.05, ignition_frame=2, seed=7),
    FlameSpec(x0=20.0, v0_px=4.0, ddt_frame=18, v_jump_px=22.0,
              ignition_frame=3, seed=11),
    FlameSpec(x0=30.0, v0_px=6.0, ignition_frame=12, seed=13),
], ids=["exit", "ddt", "late-ignition"])
def test_plain_scan_matches_jax_scans_flames(flame, method):
    """Exit truncation, DDT latch and empty-frame skipping all agree."""
    p, empty = _flame_profiles(flame)
    intens, prior = p.select_intensity(method, True)
    params = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, method)
    res = _check_all(p.frame_indices, np.asarray(p.sobel_lines),
                     np.asarray(p.gradient_lines),
                     None if intens is None else np.asarray(intens),
                     empty, prior, p.width, params)
    assert int(res.recorded.sum()) > 3


def test_plain_scan_batched_equals_per_video():
    """The batched (V, M, W) form is V independent scans with per-video
    calibration, frame rate and displacement cap."""
    rng = np.random.default_rng(5)
    v, m, w = 3, 32, 200
    sob = np.round(rng.normal(0, 30, (v, m, w))).astype(np.float32)
    grad = np.round(rng.normal(0, 15, (v, m, w))).astype(np.float32)
    empty = rng.random((v, m)) < 0.1
    prior = np.ones((v, m), bool)
    prior[:, 0] = False
    fidx = np.tile(np.arange(m, dtype=np.int32), (v, 1))
    cal = np.array([0.001, 0.002, 0.0005], np.float32)
    fr = np.array([100_000, 50_000, 20_000], np.float32)
    md = np.array([3, 5, 8], np.int32)
    params = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, "combined")
    for key in ("calibration", "frame_rate", "max_displacement_px"):
        params.pop(key)
    t = torch.from_numpy
    batched = tracking_scan_plain(
        t(fidx), t(sob), t(grad), t(empty), t(prior), width=w,
        calibration=cal, frame_rate=fr, max_displacement_px=md, **params)
    for i in range(v):
        one = tracking_scan_plain(
            t(fidx[i:i + 1]), t(sob[i:i + 1]), t(grad[i:i + 1]),
            t(empty[i:i + 1]), t(prior[i:i + 1]), width=w,
            calibration=cal[i], frame_rate=fr[i], max_displacement_px=md[i],
            **params)
        for a, b in zip(batched, one):
            assert torch.equal(a[i], b[0])


def test_scan_params_match_jax_casts():
    config = FlameDetectorConfig()
    for method in METHODS:
        p = scan_params(config, 80_000, 0.000833333, method)
        fraction = (config.threshold_fraction if method == "threshold"
                    else config.half_maximum_fraction)
        max_disp = FlameTracker(config, 80_000, 0.000833333).max_displacement_px
        expected = dict(
            min_gradient_strength=np.float32(config.min_gradient_strength),
            sobel_threshold_fraction=np.float32(config.sobel_threshold_fraction),
            ddt_velocity_jump=np.float32(config.ddt_velocity_jump_m_s),
            calibration=np.float32(0.000833333),
            frame_rate=np.float32(80_000),
            max_displacement_px=np.int32(max_disp),
            method_fraction=np.float32(fraction),
        )
        for key, want in expected.items():
            assert type(p[key]) is type(want), key
            assert p[key] == want, key
        assert p["method"] == method
        assert (p["edge_margin_px"], p["search_window_px"], p["exit_margin_px"]) == (
            config.edge_margin_px, config.search_window_px, config.exit_margin_px)


def test_threshold_product_boundary():
    """A profile value exactly at the f32 fraction × peak product: host
    scan, JAX device scan and the port pick the same position."""
    config = FlameDetectorConfig()
    w, fps, cal = 256, 100_000.0, 0.0008
    smax = np.float32(3185.1714)
    boundary = np.float32(smax * np.float32(config.sobel_threshold_fraction))
    for q in (boundary, np.nextafter(boundary, np.float32(np.inf)),
              np.nextafter(boundary, np.float32(-np.inf))):
        sob = np.zeros((2, w), dtype=np.float32)
        sob[1, 100], sob[1, 120], sob[1, 140] = smax, 500.0, q
        profiles = FrameProfiles(
            frame_indices=np.array([0, 1]),
            sobel_lines=sob,
            gradient_lines=np.zeros((2, w), np.float32),
            intensity_lines=np.zeros((2, w), np.float32),
            raw_center_lines=np.zeros((2, w), np.float32),
            signal_counts=np.array([10_000, 10_000]),
            has_prior=np.array([False, True]),
            width=w,
            total_pixels=w * 64,
        )
        host = run_tracking_scan(profiles, config, fps, cal)
        port = run_tracking_scan_device(profiles_to_torch(profiles, "cpu"),
                                        config, fps, cal)
        assert [r[:3] for r in port.rows] == [r[:3] for r in host.rows], float(q)
        params = scan_params(config, fps, cal, "combined")
        _check_all(profiles.frame_indices, sob, profiles.gradient_lines, None,
                   np.zeros(2, bool), profiles.has_prior, w, params)


def test_gradient_detector_exact_at_f64_ties():
    """TwoSum (hi, lo) differences give the host's float64 argmin order even
    at exact ties (locally linear profiles); 400 windows in one batch."""
    from hsip_tpu.track.detectors import detect_gradient

    rng = np.random.default_rng(3)
    n, w = 400, 64
    profs = np.empty((n, w), np.float32)
    s0 = np.empty(n, np.int32)
    s1 = np.empty(n, np.int32)
    for t in range(n):
        if t % 2 == 0:
            slope = rng.uniform(-30, 5)
            profs[t] = (rng.uniform(0, 50) + slope * np.arange(w)
                        + rng.normal(0, 0.01, w))
        else:
            profs[t] = rng.uniform(0, 100, w)
        s0[t] = rng.integers(0, w - 2)
        s1[t] = rng.integers(s0[t] + 2, w + 1)
    cols = torch.arange(w, dtype=torch.int32)[None]
    s0_t, s1_t = torch.from_numpy(s0), torch.from_numpy(s1)
    in_window = (cols >= s0_t[:, None]) & (cols < s1_t[:, None])
    got = _detect_gradient(torch.from_numpy(profs), in_window, cols, s0_t, s1_t,
                           torch.tensor(np.float32(10.0))).numpy()
    for t in range(n):
        h = detect_gradient(profs[t].astype(np.float64), min_strength=10.0,
                            bounds=(int(s0[t]), int(s1[t])))
        assert got[t] == (-1 if h is None else h), t


def _track_both(meta, cal, offset=0.0):
    from hsip_tpu import open_video

    with open_video(str(meta)) as video:
        host = track_video(video, FlameDetectorConfig(), cal, offset,
                           scan="host", device="cpu")
        dev = track_video(video, FlameDetectorConfig(), cal, offset,
                          scan="device", device="cpu")
    return host, dev


def test_frame_rate_zero(tmp_path):
    """A missing frame rate (0 fps) records no velocity entries on either
    scan (dt = gap/0 must not pass the dt > 0 gate)."""
    frames, _ = synthesize_flame_video(
        30, height=32, width=256,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=2, seed=41))
    meta = write_recording(
        tmp_path, "zerofps-run-1-001", frames,
        spec=CihxSpec(width=256, height=32, total_frames=30, record_rate=0))
    host, dev = _track_both(meta, 0.001)
    assert [r[:3] for r in dev.rows] == [r[:3] for r in host.rows]
    assert len(host.rows) > 5
    assert dev.tracker.get_velocity_history() == host.tracker.get_velocity_history() == []
    assert dev.break_reason == host.break_reason


def test_velocity_drop_gate_is_float64_exact(tmp_path):
    """At 10 px/frame, 20k fps, 0.0005 m/px the float64 v1 is exactly 100.0
    (no break) while float32 gives 100.00001 (an advisory stop): the port's
    device scan tracks past its f32 latch and the tables come from the
    float64 replay, equal to the host scan."""
    h, w, n = 48, 640, 24
    drop_at = 12
    edges = [40 + 10 * i for i in range(drop_at)]
    edges += [edges[-1] + 4 * (i + 1) for i in range(n - 1 - drop_at)]
    frames = np.full((n, h, w), 50, dtype=np.uint16)
    for i, e in enumerate(edges):
        frames[i + 1, :, :e] = 3000
    meta = write_recording(
        tmp_path, "vdrop-run-1-001", frames,
        spec=CihxSpec(width=w, height=h, total_frames=n, record_rate=20_000))
    host, dev = _track_both(meta, 0.0005)
    v1s = [e[1] for e in host.tracker.get_velocity_history()]
    assert 100.0 in v1s and 40.0 in v1s
    assert host.break_reason is None and dev.break_reason is None
    assert [r[:4] for r in dev.rows] == [r[:4] for r in host.rows]
    assert dev.rows[-1][0] >= n - 2


def test_cuda_scan_kernel_rejects_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are refused."""
    m, w = 4, 64
    z = torch.zeros((1, m, w))
    params = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, "combined")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tracking_scan(torch.zeros((1, m), dtype=torch.int32), z, z,
                           torch.zeros((1, m), dtype=torch.bool),
                           torch.ones((1, m), dtype=torch.bool), width=w, **params)

