"""The port's CUDA kernels on the card (marker ``cuda``; they skip without one).

This file imports neither jax nor the JAX package, so it runs on a machine
with a card and no ``hsip_tpu``, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is held against its plain PyTorch version on the same card
tensors, and both backends are held against the golden table.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hsip_tpu_torch.kernels.cuda_preprocess import (  # noqa: E402
    band_profiles_plain,
    cuda_band_profiles,
)
from hsip_tpu_torch.kernels.preprocess import band_margin  # noqa: E402
from hsip_tpu_torch.track.config import (  # noqa: E402
    FileCalibration,
    FlameDetectorConfig,
    VideoSourceConfig,
)
from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan  # noqa: E402
from hsip_tpu_torch.track.device_scan import METHODS, tracking_scan_plain  # noqa: E402
from hsip_tpu_torch.track.scan import scan_params  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "golden-run-1-001-flame-position.txt"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _broken_priors(n):
    """The main path's priors (the previous frame) with runs broken by -1,
    non-adjacent priors, two in a row, and one later than its frame."""
    prior = np.arange(-1, n - 1, dtype=np.int32)
    prior[[5, 7, 20, 21, 30]] = [-1, 2, 11, 3, 33]
    return prior


@pytest.mark.cuda
@pytest.mark.parametrize("k,sigma,runtime_counts", [
    (3, 1.5, False), (3, 1.5, True), (2, 1.5, False), (5, 2.0, False), (3, 3.0, False),
])
def test_band_kernel_matches_plain(k, sigma, runtime_counts):
    """Bit-equal to the plain chain: widths at and past the 128-column tile
    (129, 257) and narrower than the halo (7, 2), N not a multiple of the
    kernel's frame run (37), and priors that break a block's run of
    adjacent frames (-1, non-adjacent, two in a row, later than the frame).
    At the (3, 1.5) default also the runtime-count instantiation, which
    the probe entry runs there."""
    from hsip_tpu_torch.kernels.cuda_preprocess import band_profiles_probe

    def kernel(*args):
        if runtime_counts:
            return band_profiles_probe(*args, runtime_counts=True)[0]
        return cuda_band_profiles(*args)

    dev = _cuda()
    rng = np.random.default_rng(k * 10 + int(sigma * 2) + runtime_counts)
    b = 2 * band_margin(k, sigma) + 1
    for w in (1024, 1000, 250, 136, 129, 257, 7, 2):  # 7, 2: windows wider than W
        for n in (64, 37):
            band = torch.from_numpy(rng.integers(0, 4096, (n, b, w)).astype(np.float32)).to(dev)
            prior = torch.from_numpy(_broken_priors(n)).to(dev)
            got = kernel(band, prior, 5.0, k, sigma)
            want = band_profiles_plain(band, prior, 5.0, k, sigma)
            torch.cuda.synchronize()
            for g, r in zip(got, want):
                torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-5)
                assert torch.equal(g, r), (w, n)


@pytest.mark.cuda
@pytest.mark.parametrize("runtime_counts", [False, True])
@pytest.mark.parametrize("w", [1024, 250])
def test_band_kernel_reads_each_band_about_once(w, runtime_counts):
    """The bytes the kernel counts for its tile copies: with the main
    path's priors a run of F frames copies F + 1 tiles; each prior that
    breaks the run (not the first frame of a run) copies one tile more."""
    from hsip_tpu_torch.kernels.cuda_preprocess import band_plan, band_profiles_probe

    dev = _cuda()
    n, k, sigma = 300, 3, 1.5
    b = 2 * band_margin(k, sigma) + 1
    band = torch.zeros((n, b, w), device=dev)
    plan = band_plan(n, w, k, sigma)
    tile_bytes = 4 * b * plan.stride
    main = np.arange(-1, n - 1, dtype=np.int32)
    broken = _broken_priors(n)
    extra = sum(1 for i in range(n) if i % plan.run and broken[i] != i - 1)
    assert extra >= 3
    for prior, tiles in ((main, n + plan.runs), (broken, n + plan.runs + extra)):
        _, loaded = band_profiles_probe(band, torch.from_numpy(prior).to(dev), 5.0,
                                        k, sigma, runtime_counts=runtime_counts)
        assert int(loaded.item()) == plan.tiles * tiles * tile_bytes
    assert plan.runs < n // 4  # most priors come from the previous frame's tile


@pytest.mark.cuda
def test_band_kernel_refuses_a_band_past_shared_memory():
    """sigma = 8 needs a 71-row band, whose tiles exceed a block's shared
    memory: the wrapper raises a ValueError that names k, sigma and W, and
    never runs the plain version."""
    from hsip_tpu_torch.kernels.cuda_preprocess import band_plan

    dev = _cuda()
    k, sigma, w = 3, 8.0, 256
    assert band_plan(4, w, k, sigma) is None
    band = torch.zeros((4, 2 * band_margin(k, sigma) + 1, w), device=dev)
    prior = torch.arange(-1, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=r"k=3, sigma=8.0, W=256.*shared memory"):
        cuda_band_profiles(band, prior, 5.0, k, sigma)
    assert band_plan(4, w, 3, 6.0) is not None  # 55 rows still fit


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_scan_kernel_matches_plain(method):
    dev = _cuda()
    rng = np.random.default_rng(METHODS.index(method))
    v, m, w = 2, 256, 1024
    sob = np.round(rng.normal(0, 30, (v, m, w))).astype(np.float32)
    grad = np.round(rng.normal(0, 15, (v, m, w))).astype(np.float32)
    intens = np.abs(np.round(rng.normal(40, 30, (v, m, w)))).astype(np.float32)
    grad[:, :, 300] = grad[:, :, 700] = -80.0  # tied minima: first index wins
    intens[:, :, 500:504] = intens.max()       # flat peak
    t = [torch.from_numpy(x).to(dev) for x in (sob, grad, intens)]
    fidx = torch.arange(m, dtype=torch.int32, device=dev).repeat(v, 1)
    empty = torch.from_numpy(rng.random((v, m)) < 0.1).to(dev)
    prior = torch.ones((v, m), dtype=torch.bool, device=dev)
    prior[:, 0] = False
    kw = dict(width=w, intensity_lines=t[2],
              **scan_params(FlameDetectorConfig(), 100_000.0, 0.001, method))
    got = cuda_tracking_scan(fidx, t[0], t[1], empty, prior, **kw)
    want = tracking_scan_plain(fidx, t[0], t[1], empty, prior, **kw)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


def _assert_scan_equal(dev, fidx, sob, grad, empty, prior, intens, width, **params):
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
         (fidx, sob, grad, empty, prior, intens)]
    kw = dict(width=width, intensity_lines=t[5], **params)
    got = cuda_tracking_scan(*t[:5], **kw)
    want = tracking_scan_plain(*t[:5], **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_scan_kernel_four_videos_per_video_params(method):
    """V = 4 different profile sets with per-video calibration, frame rate
    and displacement cap, on a ring-aligned width (TMA bulk copies) and an
    odd one (4-byte cp.async copies)."""
    dev = _cuda()
    rng = np.random.default_rng(40 + METHODS.index(method))
    for w in (1024, 1001):
        v, m = 4, 300
        sob = np.round(rng.normal(0, 30, (v, m, w))).astype(np.float32)
        grad = np.round(rng.normal(0, 15, (v, m, w))).astype(np.float32)
        intens = np.abs(np.round(rng.normal(40, 30, (v, m, w)))).astype(np.float32)
        for i in range(v):  # a front moving right at a different speed each
            for j in range(m):
                x = min(w - 20, 30 + (i + 1) * j)
                grad[i, j, x] = -120.0
                sob[i, j, x] = 400.0
                intens[i, j, :x] = 200.0
        fidx = np.cumsum(rng.integers(1, 3, (v, m)), axis=1).astype(np.int32)
        empty = rng.random((v, m)) < 0.05
        prior = np.ones((v, m), bool)
        prior[:, 0] = False
        params = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, method)
        params.update(calibration=np.array([0.001, 0.0005, 0.002, 0.0008], np.float32),
                      frame_rate=np.array([100_000, 50_000, 20_000, 80_000], np.float32),
                      max_displacement_px=np.array([3, 5, 8, 40], np.int32))
        got = _assert_scan_equal(dev, fidx, sob, grad, empty, prior, intens, w, **params)
        assert int((got.final_position >= 0).sum()) > v * m // 4


@pytest.mark.cuda
@pytest.mark.parametrize("method,w,depth", [
    ("combined", 2048, 4), ("combined", 2050, 4), ("combined", 4096, 2),
    ("combined", 8192, 1), ("threshold", 4096, 4), ("gradient", 8000, 2),
    ("half_maximum", 16384, 1),
])
def test_scan_kernel_shallow_rings(method, w, depth):
    """Rows too wide for groups of 8 frames: the launcher's groups of 4, 2
    and 1 (TMA bulk copies, and 4-byte cp.async at W=2050), over M frames
    not a multiple of the group, at V=2 with per-video parameters."""
    from hsip_tpu_torch.track.cuda_scan import ring_depth

    dev = _cuda()
    assert ring_depth(method, w) == depth
    rng = np.random.default_rng(w + METHODS.index(method))
    v, m = 2, 203
    sob = np.round(rng.normal(0, 30, (v, m, w))).astype(np.float32)
    grad = np.round(rng.normal(0, 15, (v, m, w))).astype(np.float32)
    intens = np.abs(np.round(rng.normal(40, 30, (v, m, w)))).astype(np.float32)
    for i in range(v):  # a front moving right, 6 or 9 px a step
        for j in range(m):
            x = min(w - 1, 40 + (i + 2) * 3 * j)
            grad[i, j, x] = -120.0
            sob[i, j, x] = 400.0
            intens[i, j, :x] = 200.0
    fidx = np.cumsum(rng.integers(1, 3, (v, m)), axis=1).astype(np.int32)
    empty = rng.random((v, m)) < 0.05
    prior = np.ones((v, m), bool)
    prior[:, 0] = False
    params = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, method)
    params.update(calibration=np.array([0.001, 0.0005], np.float32),
                  frame_rate=np.array([100_000, 50_000], np.float32),
                  max_displacement_px=np.array([6, 12], np.int32))
    got = _assert_scan_equal(dev, fidx, sob, grad, empty, prior, intens, w, **params)
    assert int((got.final_position >= 0).sum()) > v * m // 4


@pytest.mark.cuda
def test_scan_kernel_refuses_rows_past_shared_memory():
    """Two frames of 'combined' rows at W=15000 exceed a block's shared
    memory: the wrapper raises, and never runs the plain version."""
    dev = _cuda()
    v, m, w = 1, 4, 15000
    lines = torch.zeros((v, m, w), dtype=torch.float32, device=dev)
    flags = torch.zeros((v, m), dtype=torch.bool, device=dev)
    fidx = torch.arange(m, dtype=torch.int32, device=dev)[None]
    kw = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, "combined")
    with pytest.raises(ValueError, match="shared memory"):
        cuda_tracking_scan(fidx, lines, lines, flags, flags, width=w, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("edge_margin", [0, 10, 37])
@pytest.mark.parametrize("method", METHODS)
def test_scan_kernel_windows_at_the_edge_margins(method, edge_margin):
    """Windows that start at edge_margin (no history yet: frames with no
    signal) and end at W - edge_margin (a front running into the right
    margin, then single-column windows)."""
    dev = _cuda()
    rng = np.random.default_rng(60 + edge_margin)
    v, m, w = 1, 400, 1000
    sob = np.zeros((v, m, w), np.float32)
    grad = np.zeros((v, m, w), np.float32)
    intens = np.full((v, m, w), 3.0, np.float32)
    for j in range(120, m):  # nothing to detect before frame 120
        x = min(w - 1, edge_margin + (j - 120) * 9)
        grad[0, j, x] = -90.0
        sob[0, j, x] = 300.0
        intens[0, j, :x + 1] = 150.0 + rng.integers(0, 3, x + 1)
    fidx = np.arange(m, dtype=np.int32)[None]
    empty = np.zeros((v, m), bool)
    prior = np.ones((v, m), bool)
    prior[:, 0] = False
    params = scan_params(FlameDetectorConfig(edge_margin_px=edge_margin,
                                             exit_margin_px=0),
                         100_000.0, 0.001, method)
    got = _assert_scan_equal(dev, fidx, sob, grad, empty, prior, intens, w, **params)
    s0, s1 = got.search_start.cpu().numpy()[0], got.search_end.cpu().numpy()[0]
    assert s0[0] == edge_margin and s1[0] == w - edge_margin
    assert (s1 == w - edge_margin).sum() > 150


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1024, 998])
def test_scan_kernel_threshold_peak_at_window_end(w):
    """Ramps rising to the right: every window's peak is its last column,
    so the first column below the level is the closed-form one past the
    window."""
    dev = _cuda()
    rng = np.random.default_rng(w)
    v, m = 2, 500
    steps = rng.integers(0, 3, (v, m, w))
    steps[:, :, ::5] = 0  # plateaus: tied peaks
    intens = (np.cumsum(steps, axis=2) + 20).astype(np.float32)
    zeros = np.zeros((v, m, w), np.float32)
    fidx = np.tile(np.arange(m, dtype=np.int32), (v, 1))
    empty = rng.random((v, m)) < 0.05
    prior = np.ones((v, m), bool)
    params = scan_params(FlameDetectorConfig(), 100_000.0, 0.001, "threshold")
    got = _assert_scan_equal(dev, fidx, zeros, zeros, empty, prior, intens, w, **params)
    finals = got.final_position.cpu().numpy()
    ends = np.minimum(got.search_end.cpu().numpy(), w) - 1
    assert ((finals == ends) & (finals >= 0)).sum() > v * m // 2


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gpu", "device"])
def test_golden_table_on_the_card(tmp_path, backend):
    from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
    from hsip_tpu_torch.pipeline import process_video_file

    _cuda()
    flame = FlameSpec(x0=30.0, v0_px=8.0, accel_px=0.3, ignition_frame=3,
                      ddt_frame=28, v_jump_px=25.0, seed=77)
    frames, _ = synthesize_flame_video(60, height=48, width=512, flame=flame)
    meta = write_recording(tmp_path, "golden-run-1-001", frames, spec=CihxSpec(
        width=512, height=48, total_frames=60, record_rate=100_000,
        bit_depth=12, start_frame=-10))
    cfg = VideoSourceConfig(name="G", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    cfg.file_calibrations = [FileCalibration(calibration=0.000833333,
                                             position_offset=1.0159,
                                             files=["run-1-"])]
    bands, scans = cuda_band_profiles.launches, cuda_tracking_scan.launches
    process_video_file(meta, cfg, backend=backend, verbose=False)
    produced = tmp_path / "out" / "golden-run-1-001-flame-position.txt"
    assert produced.read_bytes() == GOLDEN.read_bytes()
    assert cuda_band_profiles.launches > bands
    assert (cuda_tracking_scan.launches > scans) == (backend == "device")


def _library_outputs(directory, device, sc=None, mesh=None, stage_times=None):
    import hsip_tpu_torch
    from hsip_tpu_torch.track import batch

    with hsip_tpu_torch.open_collection(str(directory)) as coll:
        outs = batch.track_collection_device(coll, FlameDetectorConfig(),
                                             source_config=sc, device=device,
                                             mesh=mesh, stage_times=stage_times)
    return outs, list(batch.LAST_GROUP_PATHS)


def _write_library(directory):
    """Five ragged recordings, two of them with long dark preambles, so
    that with one video a group the clip engages for some groups."""
    from hsip_tpu_torch.io import (
        CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
    )

    for i, (n, ignition) in enumerate([(96, 2), (61, 40), (96, 3), (80, 60), (70, 2)]):
        flame = FlameSpec(x0=25.0, v0_px=384 / 40, accel_px=0.0,
                          ignition_frame=ignition, seed=200 + i)
        frames, _ = synthesize_flame_video(n, height=64, width=384, flame=flame)
        write_recording(directory, f"nova-run-{i + 1}-001", frames,
                        spec=CihxSpec(width=384, height=64, total_frames=n,
                                      record_rate=100_000, bit_depth=12))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["0.7", "off"])
@pytest.mark.parametrize("groups", ["1", "4"])
def test_fused_library_on_the_card_equals_the_cpu_run(tmp_path, monkeypatch,
                                                      groups, clip):
    """The fused group program on the card (copy stream, pinned pool, both
    CUDA kernels at V > 1) gives the CPU run's outputs, G = 1 and 4, the
    clip on and off, five times over on one pool: a pinned buffer that is
    overwritten before its copy has read it shows up as a differing run."""
    from hsip_tpu_torch.track import fused
    from hsip_tpu_torch.utils import StageTimes

    dev = _cuda()
    _write_library(tmp_path / "v")
    monkeypatch.setenv("HSIP_FUSED_GROUPS", groups)
    monkeypatch.setenv("HSIP_CLIP_EMPTY", clip)
    cpu_times = StageTimes()
    want, paths = _library_outputs(tmp_path / "v", "cpu", stage_times=cpu_times)
    assert paths == ["fused"]
    cpu_counts = {k: v for k, v in cpu_times.as_dict().items()
                  if k.startswith("count.")}
    assert (cpu_counts["count.clipped_groups"] > 0) == (clip != "off" and groups == "4")
    band0, scan0 = cuda_band_profiles.launches, cuda_tracking_scan.launches
    for rep in range(5):
        times = StageTimes()
        got, paths = _library_outputs(tmp_path / "v", dev, stage_times=times)
        assert paths == ["fused"]
        assert {k: v for k, v in times.as_dict().items()
                if k.startswith("count.")} == cpu_counts
        assert len(fused._LAST_PIPELINE_TRACE) == int(groups)
        for g, w in zip(got, want):
            assert g.merged_rows() == w.merged_rows(), rep
            assert g.break_reason == w.break_reason
            assert g.empty_frame_count == w.empty_frame_count
    assert cuda_band_profiles.launches - band0 == 5 * int(groups)
    assert cuda_tracking_scan.launches - scan0 == 5 * int(groups)
    assert any(o.rows for o in want)


@pytest.mark.cuda
@pytest.mark.parametrize("method,use_frame_diff", [("threshold", True),
                                                   ("half_maximum", False),
                                                   ("gradient", True)])
def test_fused_and_chunked_library_on_the_card_named_methods(tmp_path, monkeypatch,
                                                            method, use_frame_diff):
    dev = _cuda()
    _write_library(tmp_path / "v")
    sc = VideoSourceConfig(name="t", detection_method=method,
                           use_frame_diff=use_frame_diff,
                           save_frame_images=False, save_stacked_sequences=False)
    want, _ = _library_outputs(tmp_path / "v", "cpu", sc)
    for fused_on, path in (("1", "fused"), ("0", "chunked")):
        monkeypatch.setenv("HSIP_FUSED", fused_on)
        got, paths = _library_outputs(tmp_path / "v", dev, sc)
        assert paths == [path]
        for g, w in zip(got, want):
            assert g.merged_rows() == w.merged_rows(), path


@pytest.mark.cuda
def test_map_phase_staging_reuses_the_pinned_pool(tmp_path):
    """Per-file runs back to back take their chunk buffers from the pool
    the library path uses, and the tables do not change."""
    from hsip_tpu_torch.pipeline import process_video_file
    from hsip_tpu_torch.track import fused

    _cuda()
    _write_library(tmp_path / "v")
    cfg = VideoSourceConfig(name="t", save_frame_images=False,
                            save_stacked_sequences=False)
    meta = tmp_path / "v" / "nova-run-1-001.cihx"
    want = process_video_file(meta, cfg, backend="device", verbose=False,
                              write_outputs=False, device="cpu").merged_rows()
    for _ in range(4):
        got = process_video_file(meta, cfg, backend="device", verbose=False,
                                 write_outputs=False)
        assert got.merged_rows() == want
    pooled = [e for e in fused._STAGING_POOL if e[1].is_pinned()]
    assert pooled and len(fused._STAGING_POOL) <= fused._STAGING_POOL_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("fused_on", ["1", "0"])
@pytest.mark.parametrize("slots", [2, 3])
def test_library_over_a_mesh_on_the_card_equals_the_cpu_run(tmp_path, monkeypatch,
                                                            slots, fused_on):
    """Every slot on the card: each slot's group programs launch both
    kernels (fused), or each slot scans its own videos (chunked); the
    outputs are the CPU run's."""
    from hsip_tpu_torch.parallel import make_mesh
    from hsip_tpu_torch.track import fused

    dev = _cuda()
    _write_library(tmp_path / "v")
    want, _ = _library_outputs(tmp_path / "v", "cpu")
    monkeypatch.setenv("HSIP_FUSED", fused_on)
    scans = cuda_tracking_scan.launches
    got, paths = _library_outputs(tmp_path / "v", None,
                                  mesh=make_mesh("video", devices=[dev] * slots))
    assert paths == ["fused" if fused_on == "1" else "chunked"]
    for g, w in zip(got, want):
        assert g.merged_rows() == w.merged_rows()
        assert (g.break_reason, g.empty_frame_count) == (w.break_reason, w.empty_frame_count)
    if fused_on == "1":
        for slot in range(slots):
            launched = [t["launches"] for t in fused._LAST_PIPELINE_TRACE
                        if t["slot"] == slot]
            assert launched and all(band >= 1 and scan >= 1 for band, scan in launched)
    else:
        assert cuda_tracking_scan.launches - scans == slots


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["host", "device"])
@pytest.mark.parametrize("slots", [2, 4])
def test_track_video_over_a_frame_mesh_on_the_card(tmp_path, slots, scan):
    """The frame-sharded map phase with every slot on the card: three
    chunks of 32 frames, one band kernel launch a slot a chunk, the rows of
    the CPU run."""
    import hsip_tpu_torch
    from hsip_tpu_torch.parallel import make_mesh
    from hsip_tpu_torch.track.scan import track_video

    dev = _cuda()
    _write_library(tmp_path / "v")
    cfg = FlameDetectorConfig()
    with hsip_tpu_torch.open_video(str(tmp_path / "v" / "nova-run-1-001.cihx")) as video:
        want = track_video(video, cfg, 0.001, scan=scan, device="cpu")
        band0 = cuda_band_profiles.launches
        got = track_video(video, cfg, 0.001, scan=scan, chunk_size=32,
                          mesh=make_mesh("frame", devices=[dev] * slots))
    assert cuda_band_profiles.launches - band0 == 3 * slots
    assert [r[:4] for r in got.rows] == [r[:4] for r in want.rows]
    assert len(want.rows) > 10


# ---- the sweeps of tests/test_fuzz.py on the card (the draws as
# chip_smoke.py writes them out; tests/test_torch_fuzz.py holds them to the
# JAX file's) ----


@pytest.fixture(scope="module")
def recipes():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_recipes", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def card():
    return _cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_scan_kernel_adversarial_classes(card, recipes, method):
    """Noise, heavy ties, sparse spikes and a flat plateau at W=250, M=25,
    edge margin 0, scattered frame indices, frame rate 0 drawn: all nine
    fields equal to the plain version's."""
    frame_rates = set()
    for kind, fidx, sob, grad, prof, empty, prior, kw in recipes.adversarial_scan_cases(method):
        args = tuple(torch.from_numpy(x)[None].to(card) for x in (fidx, sob, grad, empty, prior))
        kw = dict(kw, intensity_lines=None if method == "combined"
                  else torch.from_numpy(prof)[None].to(card))
        got = cuda_tracking_scan(*args, **kw)
        want = tracking_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(a, b), (kind, name)
        frame_rates.add(float(kw["frame_rate"]))
    assert frame_rates & {0.0}


@pytest.mark.cuda
@pytest.mark.parametrize("seed,route,depth", [(1, "packed", 12), (0, "band+counts", 8)],
                         ids=["packed-12-bit", "8-bit"])
def test_sweep_config_on_the_card_equals_the_cpu_run(tmp_path, card, recipes, seed, route,
                                                     depth):
    """A config of the sweep whose rows are not byte-aligned (the 'packed'
    route: whole frames decoded on the card) and an 8-bit one, both
    backends on the card against the CPU run."""
    from hsip_tpu_torch import io
    from hsip_tpu_torch.pipeline import process_video_file

    case = recipes.fuzz_pipeline_case(seed)
    assert case["depth"] == depth
    meta = recipes.write_fuzz_recording(case, tmp_path / "rec", io)
    config = FlameDetectorConfig(**case["detector"])
    lines = [recipes.map_phase_lines(meta, config, case["source"]["skip_frames"], where)
             for where in (card, "cpu")]
    assert lines[0].staging_route == lines[1].staging_route == route
    assert np.array_equal(lines[0].signal_counts, lines[1].signal_counts)
    for name in ("sobel_lines", "gradient_lines", "intensity_lines", "raw_center_lines"):
        torch.testing.assert_close(torch.from_numpy(getattr(lines[0], name)),
                                   torch.from_numpy(getattr(lines[1], name)),
                                   atol=1e-4, rtol=1e-5)
    for backend in ("gpu", "device"):
        outs = {}
        for i, where in enumerate((card, "cpu")):
            src = VideoSourceConfig(save_frame_images=False, save_stacked_sequences=False,
                                    **case["source"])
            src.output_dir = str(tmp_path / f"{backend}-{i}")
            bands = cuda_band_profiles.launches
            outs[where] = process_video_file(meta, src, config, backend=backend,
                                             verbose=False, device=where)
            launched = cuda_band_profiles.launches - bands
            assert outs[where].phase_timings["staging_route"] == route
            assert (launched >= 1) == (where is card), (backend, where)
        a, b = outs[card], outs["cpu"]
        assert (a.rows, a.break_reason, a.empty_frame_count) == (
            b.rows, b.break_reason, b.empty_frame_count)
        tables = [sorted((p.name, p.read_bytes())
                         for p in (tmp_path / f"{backend}-{i}").glob("*.txt"))
                  for i in range(2)]
        assert tables[0] == tables[1]
