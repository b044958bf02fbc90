"""The port's device-mesh layer against ``hsip_tpu.parallel`` on the CPU.

The port's meshes put their slots on the CPU (``devices=["cpu"] * n``, the
counterpart of the JAX package's 8 virtual CPU devices, on which the JAX
side runs here), so the halo copies, the per-slot band chains and scans
and the per-slot budgets run through the code several cards would run,
with the kernels' plain PyTorch versions. Inputs come from numpy seeds.
Profiles are held to the port's tolerance against the JAX package (atol
1e-4, rtol 1e-5, as ``tests/test_torch_preprocess.py``); counts, raw
center rows, integer positions and every table byte are equal, and the
port's sharded profiles are bit-equal to its own unsharded map phase.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hsip_tpu  # noqa: E402
import hsip_tpu.parallel as jpar  # noqa: E402
import hsip_tpu.track.batch as jax_batch  # noqa: E402
from hsip_tpu.parallel.dryrun import run_multichip_dryrun as jax_dryrun  # noqa: E402
from hsip_tpu.track import FlameDetectorConfig as JaxDetectorConfig  # noqa: E402
from hsip_tpu.track.config import VideoSourceConfig as JaxSourceConfig  # noqa: E402

import hsip_tpu_torch  # noqa: E402
import hsip_tpu_torch.parallel as par  # noqa: E402
import hsip_tpu_torch.track.batch as port_batch  # noqa: E402
import hsip_tpu_torch.track.fused as port_fused  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.kernels.preprocess import batch_centerline_profiles  # noqa: E402
from hsip_tpu_torch.parallel.dryrun import (  # noqa: E402
    run_multichip_dryrun,
    run_pipeline_dryrun,
)
from hsip_tpu_torch.parallel.mesh import shard_bounds  # noqa: E402
from hsip_tpu_torch.track.config import FlameDetectorConfig, VideoSourceConfig  # noqa: E402
from hsip_tpu_torch.track.scan import (  # noqa: E402
    _compute_profiles_sharded,
    compute_profiles_batched,
    track_video,
)

TOL = dict(atol=1e-4, rtol=1e-5)


def _cpu_mesh(n, axis="frame"):
    return par.make_mesh(axis, devices=["cpu"] * n)


def _write(d, name, n=40, height=32, width=256, seed=0, shift=0, **flame):
    flame = dict(dict(x0=25.0, v0_px=6.0, ignition_frame=2), **flame)
    frames, _ = synthesize_flame_video(n, height=height, width=width,
                                       flame=FlameSpec(seed=seed, **flame))
    frames = frames >> shift
    return write_recording(d, name, frames, spec=CihxSpec(
        width=width, height=height, total_frames=n, record_rate=100_000,
        bit_depth=12))


# ---- meshes ----

def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = _cpu_mesh(8)
    assert mesh.shape == {"frame": 8} and mesh.size == 8
    assert mesh.axis_names == ("frame",)
    assert [str(d) for d in mesh.devices] == ["cpu"] * 8
    assert par.make_mesh("frame", devices=["cpu"] * 8, n_devices=4).shape["frame"] == 4
    with pytest.raises(ValueError, match="make_mesh needs 9 devices, found 8"):
        par.make_mesh("frame", devices=["cpu"] * 8, n_devices=9)
    # The JAX function raises the same for too many devices.
    with pytest.raises(ValueError, match="make_mesh needs 9 devices, found 8"):
        jpar.make_mesh("frame", n_devices=9)
    with pytest.raises(ValueError, match="at least one device"):
        par.make_mesh("frame", devices=[])
    # The default is the local cards: none here, and never the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        par.make_mesh("video")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in par.make_mesh("video").devices] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="make_mesh needs 4 devices, found 2"):
        par.make_mesh("video", n_devices=4)
    with pytest.raises(ValueError, match="all CUDA devices or all the CPU"):
        par.make_mesh("video", devices=["cpu", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device 5"):
        par.make_mesh("video", devices=["cuda:5"])


def test_video_frame_mesh_and_frame_sharding():
    mesh = par.video_frame_mesh(2, devices=["cpu"] * 8)
    jmesh = jpar.video_frame_mesh(2)
    assert mesh.shape == dict(jmesh.shape) == {"video": 2, "frame": 4}
    assert mesh.devices.shape == jmesh.devices.shape
    assert len(mesh.slots("frame")) == 4 and len(mesh.slots("video")) == 2
    with pytest.raises(ValueError):
        par.video_frame_mesh(3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="no 'video' axis"):
        _cpu_mesh(2).slots("video")
    sharding = par.frame_sharding(_cpu_mesh(4))
    assert sharding.bounds(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert sharding.bounds(10) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert shard_bounds(3, 8) == [(0, 1), (1, 2), (2, 3)] + [(3, 3)] * 5


def test_exports_match_the_jax_package():
    assert sorted(par.__all__) == sorted(
        "VideoProcessor" if n == "TPUVideoProcessor" else n for n in jpar.__all__)
    for name in par.__all__:
        assert callable(getattr(par, name)), name


# ---- the sharded map phase ----

def _frames(n=24, height=32, width=256, seed=9):
    """Flame frames scaled to pixel values below 64: XLA may contract
    a*b+c into an FMA, so the jnp chain is not bit-equal to an uncontracted
    one (``tests/test_torch_preprocess.py`` keeps its pixels small for the
    same reason), and at 12-bit values the difference of two rounded tap
    sums exceeds atol 1e-4. The port's own unsharded chain is held
    bit-equal at these and at full-scale values."""
    frames, _ = synthesize_flame_video(
        n, height=height, width=width,
        flame=FlameSpec(x0=25.0, v0_px=6.0, ignition_frame=2, seed=seed))
    return frames >> 6


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_profiles_match_jax_and_the_unsharded_chain(n_dev):
    frames = _frames()
    bg = float(np.max(frames[0]))
    noise = max(10.0, bg * 0.5)
    got = par.sharded_centerline_profiles(frames, bg, 5.0, noise, _cpu_mesh(n_dev))
    want = jpar.sharded_centerline_profiles(
        frames, bg, 5.0, noise, jpar.make_mesh("frame", n_devices=n_dev))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))  # raw rows
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))  # counts
    assert got[4].dtype == np.int32
    # The port's own unsharded chain on the same frames: bit-equal.
    prior = torch.arange(-1, frames.shape[0] - 1, dtype=torch.int32)
    single = batch_centerline_profiles(
        torch.from_numpy(frames.astype(np.float32)), float(np.float32(bg)), prior,
        5.0, float(np.float32(noise)))
    for g, s in zip(got, single):
        np.testing.assert_array_equal(g, s.numpy())
    assert not got[0][0].any() and not got[1][0].any()  # frame 0: no prior


def test_sharded_profiles_pad_to_the_slot_count():
    frames = _frames(10, width=128)
    bg = float(np.max(frames[0]))
    got = par.sharded_centerline_profiles(frames, bg, 5.0, 10.0, _cpu_mesh(8))
    want = jpar.sharded_centerline_profiles(frames, bg, 5.0, 10.0, jpar.make_mesh("frame"))
    assert [g.shape for g in got] == [(10, 128)] * 4 + [(10,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    fn = par.make_sharded_profile_fn(_cpu_mesh(8), 32, 128)
    with pytest.raises(ValueError, match="do not split over 8 slots"):
        fn(frames, bg, 5.0, 10.0)


def test_even_kernel_folding_band_is_refused_word_for_word():
    for make, mesh in ((par.make_sharded_profile_fn, _cpu_mesh(2)),
                       (jpar.make_sharded_profile_fn, jpar.make_mesh("frame", n_devices=2))):
        with pytest.raises(ValueError) as err:
            make(mesh, 12, 256, morphology_kernel_size=4)
        assert str(err.value) == (
            "Even morphology kernels with a folding centerline band are not "
            "exact under reflect row-gathering; use the host pipeline for "
            "this geometry (H=12, k=4)")


# ---- track_video over a frame mesh ----

def _rows(out):
    return [r[:4] for r in out.rows]


@pytest.mark.parametrize("scan", ["host", "device"])
def test_track_video_over_a_mesh_equals_the_unsharded_run(tmp_path, scan):
    """Streamed chunks (a chunk size that forces several), skip frames
    across chunk boundaries, slot counts that do not divide the chunks."""
    meta = _write(tmp_path, "mesh-tv-run-1", n=41, seed=17, accel_px=0.1)
    cfg = FlameDetectorConfig()
    skip = [0, 7, 8, 20, 33]
    with hsip_tpu_torch.open_video(str(meta)) as video:
        for skip_frames in ((), skip):
            single = track_video(video, cfg, 0.0008, 1.0, skip_frames=skip_frames,
                                 scan=scan, device="cpu")
            assert len(single.rows) > 20
            for n_dev, chunk_size in ((2, None), (3, 8), (4, 16), (8, 8)):
                sharded = track_video(video, cfg, 0.0008, 1.0, mesh=_cpu_mesh(n_dev),
                                      skip_frames=skip_frames, scan=scan,
                                      chunk_size=chunk_size)
                assert _rows(sharded) == _rows(single), (n_dev, chunk_size)
                assert sharded.break_reason == single.break_reason
                assert sharded.tracker.ddt_frame == single.tracker.ddt_frame
                assert sharded.total_frames == 41
                assert sharded.phase_timings["staging_route"] == "band+counts"
            assert not {r[0] for r in sharded.rows} & set(skip_frames)


def test_sharded_map_phase_is_bit_equal_and_streams(tmp_path):
    meta = _write(tmp_path, "stream-run-1", n=37, seed=14)
    cfg = FlameDetectorConfig()
    with hsip_tpu_torch.open_video(str(meta)) as video:
        bg = float(np.max(video[0]))
        single = compute_profiles_batched(video.read_batch, len(video), video.frame_shape,
                                          bg, cfg, device="cpu")
        chunks = []
        # frames_per_shard=2 over 4 slots: chunks of 8 with a one-frame overlap.
        sharded = _compute_profiles_sharded(video, bg, cfg, (), _cpu_mesh(4),
                                            frames_per_shard=2,
                                            progress=lambda done, m: chunks.append(done))
        on_device = _compute_profiles_sharded(video, bg, cfg, (), _cpu_mesh(3),
                                              frames_per_shard=5, keep_device=True)
    assert chunks == [8, 16, 24, 32, 37]
    for name in ("sobel_lines", "gradient_lines", "intensity_lines",
                 "raw_center_lines", "signal_counts", "has_prior", "frame_indices"):
        np.testing.assert_array_equal(getattr(sharded, name), getattr(single, name))
        got = getattr(on_device, name)
        np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor)
                                      else got, getattr(single, name))
    assert isinstance(on_device.sobel_lines, torch.Tensor)


def test_sharded_map_phase_decoded_route_equals_jax(tmp_path):
    """Without the native band gather each slot receives decoded frames
    (the JAX package's own staging): profiles as the JAX mesh run's."""
    from hsip_tpu.track.scan import _compute_profiles_sharded as jax_sharded

    meta = _write(tmp_path, "decoded-run-1", n=21, seed=3, shift=6)
    cfg = FlameDetectorConfig()
    with hsip_tpu_torch.open_video(str(meta)) as video, \
            hsip_tpu.open_video(str(meta)) as jvideo:
        video.staging_paths = lambda: (None, None, None, 12)
        bg = float(np.max(video[0]))
        got = _compute_profiles_sharded(video, bg, cfg, (3,), _cpu_mesh(4),
                                        frames_per_shard=3)
        want = jax_sharded(jvideo, bg, JaxDetectorConfig(), (3,),
                           jpar.make_mesh("frame", n_devices=4), frames_per_shard=3)
    assert got.staging_route == "decoded"
    for name in ("sobel_lines", "gradient_lines", "intensity_lines"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), **TOL)
    for name in ("raw_center_lines", "signal_counts", "frame_indices", "has_prior"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_track_video_over_a_mesh_even_kernel_folding_fallback(tmp_path):
    meta = _write(tmp_path, "fold-mesh-run-1", n=24, height=12, seed=19)
    cfg = FlameDetectorConfig(morphology_kernel_size=4)
    with hsip_tpu_torch.open_video(str(meta)) as video:
        single = track_video(video, cfg, 0.001, device="cpu")
        for scan in ("host", "device"):
            sharded = track_video(video, cfg, 0.001, mesh=_cpu_mesh(4), scan=scan)
            assert _rows(sharded) == _rows(single)
            assert sharded.phase_timings["staging_route"] == "host_exact"
    with hsip_tpu.open_video(str(meta)) as jvideo:
        from hsip_tpu.track.scan import track_video as jax_track_video

        want = jax_track_video(jvideo, JaxDetectorConfig(morphology_kernel_size=4),
                               0.001, mesh=jpar.make_mesh("frame", n_devices=4))
    assert _rows(want) == _rows(single)


# ---- library mode over a video mesh ----

def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.merged_rows() == w.merged_rows()
        assert (g.break_reason, g.break_frame, g.empty_frame_count, g.total_frames) == \
            (w.break_reason, w.break_frame, w.empty_frame_count, w.total_frames)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """Three recordings of one shape, one of another: V=3 is not a
    multiple of the slot counts below."""
    d = tmp_path_factory.mktemp("mesh_library")
    for i, n in enumerate((40, 25, 33)):
        _write(d, f"nova-run-{i + 1}-001", n=n, height=64, width=384, seed=40 + i,
               v0_px=384 / (1.4 * n))
    _write(d, "mini-run-1-001", n=20, height=32, width=256, seed=50, v0_px=9.0)
    return d


@pytest.mark.parametrize("method", ["combined", "half_maximum"])
def test_library_over_a_mesh_equals_the_jax_mesh_run(library, method, monkeypatch):
    sc = VideoSourceConfig(name="t", detection_method=method)
    jsc = JaxSourceConfig(name="t", detection_method=method)
    with hsip_tpu.open_collection(str(library)) as coll:
        want = jax_batch.track_collection_device(
            coll, JaxDetectorConfig(), source_config=jsc,
            mesh=jpar.make_mesh("video", n_devices=2))
    for fused in ("1", "0"):
        monkeypatch.setenv("HSIP_FUSED", fused)
        for n_dev in (2, 8):
            with hsip_tpu_torch.open_collection(str(library)) as coll:
                got = port_batch.track_collection_device(
                    coll, FlameDetectorConfig(), source_config=sc,
                    mesh=_cpu_mesh(n_dev, "video"))
            _assert_same(got, want)
            assert port_batch.LAST_GROUP_PATHS == \
                ["fused" if fused == "1" else "chunked"] * 2


def test_fused_mesh_groups_run_round_robin_over_the_slots(library):
    with hsip_tpu_torch.open_collection(str(library)) as coll:
        port_batch.track_collection_device(coll, FlameDetectorConfig(),
                                           mesh=_cpu_mesh(2, "video"))
    # The last shape group (3 videos): slot 0 takes two, slot 1 one, each
    # video its own group; the slots' first groups are gathered first.
    assert [(t["slot"], t["device"]) for t in port_fused._LAST_PIPELINE_TRACE] == \
        [(0, "cpu"), (1, "cpu"), (0, "cpu")]


def test_fused_budget_is_per_card(library, monkeypatch):
    """Slots that share a device share its limit: a group that fits one
    slot's half of the memory but not the card's whole falls to the
    chunked path rather than giving each slot the card."""
    need = port_fused._fused_budget_bytes(2, 40, 384, 19, 12, 2) \
        + port_fused._fused_budget_bytes(1, 40, 384, 19, 12, 1)
    monkeypatch.setattr(port_fused, "_fused_limit_bytes", lambda dev: need - 1)
    with hsip_tpu_torch.open_collection(str(library)) as coll:
        port_batch.track_collection_device(coll, FlameDetectorConfig(),
                                           mesh=_cpu_mesh(2, "video"))
    assert port_batch.LAST_GROUP_PATHS[1] == "chunked"
    monkeypatch.setattr(port_fused, "_fused_limit_bytes", lambda dev: need)
    with hsip_tpu_torch.open_collection(str(library)) as coll:
        port_batch.track_collection_device(coll, FlameDetectorConfig(),
                                           mesh=_cpu_mesh(2, "video"))
    assert port_batch.LAST_GROUP_PATHS[1] == "fused"


# ---- the dry runs ----

def test_multichip_dryrun_equals_the_jax_dryrun():
    pos_g, pos_s, total = run_multichip_dryrun(8, devices=["cpu"] * 8)
    want_g, want_s, want_total = jax_dryrun(8)
    assert total == want_total > 0
    assert pos_g.shape == pos_s.shape == (2, 8)
    # Equal but where the two profiles tie within the tolerance at both
    # candidate columns (a near-tie the argmin may break either way): none
    # at this seed.
    np.testing.assert_array_equal(pos_g, np.asarray(want_g))
    np.testing.assert_array_equal(pos_s, np.asarray(want_s))
    with pytest.raises(RuntimeError, match="needs 8 devices, found 4"):
        run_multichip_dryrun(8, devices=["cpu"] * 4)


def test_pipeline_dryrun():
    assert run_pipeline_dryrun(8, devices=["cpu"] * 8) == (3, "fused")


def test_the_jax_side_has_eight_virtual_devices():
    assert len(jax.devices()) == 8
