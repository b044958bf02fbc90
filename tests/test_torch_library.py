"""The port's library mode against the JAX package and its own per-file run.

``hsip_tpu_torch.track.batch.track_collection_device`` runs here on the CPU
(``device="cpu"``: the plain PyTorch versions of both kernels) on small
recordings made from seeds. Its outputs must equal those of
``hsip_tpu.track.batch.track_collection_device`` on the same files (the JAX
side as its own tests run it on the CPU: the vmapped ``lax.scan``, and once
the Pallas kernel in interpret mode) and those of the port's per-file
``device`` scan. Tolerance: none — merged rows (positions, times, float64
velocities), ``break_reason``, ``empty_frame_count`` and the bytes of every
table are equal.

Every JAX run of this file hands its device puts private copies
(:func:`pin_reference_puts`): on the CPU the JAX package's pipelined groups
can otherwise read a staging buffer that the next group has refilled.
"""

import os
import time

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import hsip_tpu  # noqa: E402
import hsip_tpu.pipeline as jax_pipeline  # noqa: E402
import hsip_tpu.track.batch as jax_batch  # noqa: E402
import hsip_tpu.track.fused as jax_fused  # noqa: E402
from hsip_tpu.kernels.preprocess import band_margin as jax_band_margin  # noqa: E402
from hsip_tpu.track import FlameDetectorConfig as JaxDetectorConfig  # noqa: E402
from hsip_tpu.track.config import VideoSourceConfig as JaxSourceConfig  # noqa: E402

import hsip_tpu_torch  # noqa: E402
import hsip_tpu_torch.pipeline as port_pipeline  # noqa: E402
import hsip_tpu_torch.track.batch as port_batch  # noqa: E402
import hsip_tpu_torch.track.fused as port_fused  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.track.config import (  # noqa: E402
    FileCalibration, FlameDetectorConfig, VideoSourceConfig,
)
from hsip_tpu_torch.track.scan import track_video  # noqa: E402
from hsip_tpu_torch.utils import StageTimes  # noqa: E402


def pin_reference_puts(monkeypatch):
    """Make every ``jax.device_put`` of a numpy array put a private copy.

    The JAX package's fused library stages each pipelined group in one
    pooled host buffer, and the next group's gather refills it as soon as
    the group's puts are ready (``hsip_tpu/track/fused.py``,
    ``_pooled_staging``). On a CPU backend a put of a 64-byte-aligned numpy
    array is no copy: the device array IS the pooled buffer, ready at once,
    and the group's program runs asynchronously. If it has not read its
    input when the next gather lands, it tracks the next group's videos.
    Whether the pool's buffer is aligned depends on the heap, so the
    reference's answer changed from run to run. With a private copy each
    put holds its own gather's bytes, as a put to a device's own memory
    does. Output-neutral for the port, which never calls JAX."""
    put = jax.device_put

    def copying_put(x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            x = x.copy()
        return put(x, *args, **kwargs)

    monkeypatch.setattr(jax, "device_put", copying_put)


@pytest.fixture(autouse=True)
def _reference_puts_copy(monkeypatch):
    pin_reference_puts(monkeypatch)


def _write(d, name, n_frames=40, height=64, width=384, seed=0, bit_depth=12,
           ignition=2, v0=None):
    flame = FlameSpec(x0=25.0,
                      v0_px=width / (1.4 * n_frames) if v0 is None else v0,
                      accel_px=0.0, ignition_frame=ignition, seed=seed)
    frames, _ = synthesize_flame_video(n_frames, height=height, width=width,
                                       flame=flame)
    if bit_depth < 12:
        frames = (frames >> (12 - bit_depth)).astype(frames.dtype)
    spec = CihxSpec(width=width, height=height, total_frames=n_frames,
                    record_rate=100_000, bit_depth=bit_depth)
    return write_recording(d, name, frames, spec=spec)


def _source(cls, **kw):
    kw.setdefault("name", "t")
    kw.setdefault("save_frame_images", False)
    kw.setdefault("save_stacked_sequences", False)
    cals = kw.pop("cals", None)
    sc = cls(**kw)
    if cals:
        sc.file_calibrations = cals
    return sc


def _port_library(d, det=None, device="cpu", **kw):
    with hsip_tpu_torch.open_collection(str(d)) as coll:
        return port_batch.track_collection_device(
            coll, det or FlameDetectorConfig(), device=device, **kw)


def _jax_library(d, det=None, **kw):
    with hsip_tpu.open_collection(str(d)) as coll:
        return jax_batch.track_collection_device(
            coll, det or JaxDetectorConfig(), **kw)


def _port_per_file(d, det=None, sc=None):
    """The port's per-file 'device' scan of every recording, in the
    collection's order."""
    det = det or FlameDetectorConfig()
    outs = []
    with hsip_tpu_torch.open_collection(str(d)) as coll:
        for v in coll:
            cal, off = (sc.get_calibration_for_file(v.filepath.name)
                        if sc is not None else (1.0, 0.0))
            outs.append(track_video(
                v, det, cal, off, scan="device", device="cpu",
                detection_method=sc.detection_method if sc else "combined",
                use_frame_diff=sc.use_frame_diff if sc else True,
            ))
    return outs


def _tables(pipeline_mod, outs, out_dir):
    """Every output's tables, written by ``pipeline_mod``'s writer."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, out in enumerate(outs):
        if out.rows:
            pipeline_mod._write_ddt_split_tables(out, out_dir, f"v{i}", False)
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.txt"))}


def _assert_same(got, want, what="port against reference"):
    """Every output of ``got`` equals ``want``'s; a mismatch names the
    field, the video index and both values."""
    assert len(got) == len(want), f"{what}: {len(got)} outputs against {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        rg, rw = g.merged_rows(), w.merged_rows()
        if rg != rw:
            j = next((j for j, (a, b) in enumerate(zip(rg, rw)) if a != b),
                     min(len(rg), len(rw)))
            pytest.fail(f"{what}: video {i}, merged_rows: {len(rg)} rows against "
                        f"{len(rw)}, first difference at row {j}: "
                        f"{rg[j] if j < len(rg) else None} against "
                        f"{rw[j] if j < len(rw) else None}")
        for field in ("break_reason", "break_frame", "empty_frame_count",
                      "total_frames"):
            a, b = getattr(g, field), getattr(w, field)
            assert a == b, f"{what}: video {i}, {field}: {a!r} against {b!r}"


def _assert_same_tables(got, want, what):
    """Byte-equal table sets; a mismatch names the files that differ."""
    differ = sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))
    assert not differ, f"{what}: tables differ: {differ}"


def _check_against_both(d, tmp_path, det_kw=None, sc_kw=None, jax_mode=None,
                        monkeypatch=None):
    """Port library == JAX library == port per-file, tables included; the
    fused path engaged."""
    det_kw, sc_kw = det_kw or {}, sc_kw or {}
    sc = _source(VideoSourceConfig, **sc_kw) if sc_kw else None
    jsc = None
    if sc_kw:
        kw = dict(sc_kw)
        if "cals" in kw:
            from hsip_tpu.track import FileCalibration as JaxFileCalibration

            kw["cals"] = [JaxFileCalibration(calibration=c.calibration,
                                             position_offset=c.position_offset,
                                             files=list(c.files))
                          for c in kw["cals"]]
        jsc = _source(JaxSourceConfig, **kw)
    if jax_mode is not None:
        monkeypatch.setattr(jax_batch, "_PALLAS_MODE", jax_mode)
    got = _port_library(d, FlameDetectorConfig(**det_kw), source_config=sc)
    paths = port_batch.LAST_GROUP_PATHS
    assert paths and set(paths) == {"fused"}, f"group paths {paths}"
    ref = _jax_library(d, JaxDetectorConfig(**det_kw), source_config=jsc)
    per_file = _port_per_file(d, FlameDetectorConfig(**det_kw), sc)
    assert any(o.rows for o in got), "the port's library run tracked no rows"
    _assert_same(got, ref, "port library against JAX library")
    _assert_same(got, per_file, "port library against port per-file")
    port_tables = _tables(port_pipeline, got, tmp_path / "t_port")
    assert port_tables, "the port's library run wrote no table"
    _assert_same_tables(port_tables, _tables(jax_pipeline, ref, tmp_path / "t_jax"),
                        "port library against JAX library")
    _assert_same_tables(port_tables,
                        _tables(port_pipeline, per_file, tmp_path / "t_file"),
                        "port library against port per-file")
    return got


@pytest.mark.parametrize("lengths,jax_mode", [((40, 40, 40), None),
                                              ((40, 25), None),
                                              ((40, 25, 33), "interpret")])
def test_fused_matches_jax_and_per_file(tmp_path, monkeypatch, lengths, jax_mode):
    d = tmp_path / "v"
    for i, n in enumerate(lengths):
        _write(d, f"nova-run-{i + 1}-001", n_frames=n, seed=i + 1)
    _check_against_both(d, tmp_path, jax_mode=jax_mode, monkeypatch=monkeypatch)
    assert port_batch.LAST_GROUP_PATHS == ["fused"]


@pytest.mark.parametrize("method", ["threshold", "half_maximum", "gradient"])
@pytest.mark.parametrize("use_frame_diff", [True, False])
def test_fused_named_methods_match(tmp_path, method, use_frame_diff):
    d = tmp_path / "v"
    _write(d, "nova-run-1-001", seed=3)
    _write(d, "nova-run-2-001", n_frames=31, seed=4)
    _check_against_both(d, tmp_path, sc_kw=dict(
        detection_method=method, use_frame_diff=use_frame_diff))


@pytest.mark.parametrize("bit_depth", [8, 10, 12, 16])
def test_fused_bit_depths_match(tmp_path, bit_depth):
    d = tmp_path / "v"
    _write(d, "nova-run-1-001", seed=5, bit_depth=bit_depth)
    _write(d, "nova-run-2-001", n_frames=28, seed=6, bit_depth=bit_depth)
    _check_against_both(d, tmp_path)


def test_fused_per_video_calibrations_match(tmp_path):
    d = tmp_path / "v"
    for i in range(3):
        _write(d, f"nova-run-{i + 1}-001", seed=10 + i, v0=9.0 + 3 * i)
    cals = [FileCalibration(calibration=0.000833333, position_offset=1.0159,
                            files=["run-1-"]),
            FileCalibration(calibration=0.0004, position_offset=0.25,
                            files=["run-3-"])]
    got = _check_against_both(d, tmp_path, sc_kw=dict(
        calibration=0.0011, position_offset=0.5, cals=cals))
    # Three different calibrations reached the rows (position in metres).
    first_m = [o.rows[0][3] - o.rows[0][2] * c for o, c in
               zip(got, (0.000833333, 0.0011, 0.0004))]
    assert first_m == pytest.approx([1.0159, 0.5, 0.25])


def _aligned_empty(shape, align=64):
    """An uninitialised uint8 array whose data starts on an ``align``-byte
    boundary."""
    n = int(np.prod(shape))
    raw = np.empty(n + align, np.uint8)
    off = -raw.ctypes.data % align
    return raw[off:off + n].reshape(shape)


class _RunsAtFetch:
    """A reference group's result whose program runs only when the result
    is fetched, after every group's gather."""

    def __init__(self, program, args):
        self.program, self.args = program, args

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.program(*self.args), dtype)


@pytest.mark.parametrize("offset", [0, 16])
def test_pinned_reference_put_keeps_the_bytes_of_its_call(offset):
    """Under the pin a put keeps the bytes it was given, whether or not the
    buffer is 64-byte aligned (unpinned, an aligned one is aliased)."""
    buf = _aligned_empty((4096 + offset,))[offset:]
    buf[:] = 1
    dev = jax.device_put(buf)
    buf[:] = 2
    assert int(np.asarray(dev).max()) == 1


@pytest.mark.parametrize("lengths,seeds,bit_depth,jax_mode", [
    ((40, 28), (5, 6), 8, None),
    ((40, 25, 33), (1, 2, 3), 12, "interpret"),
])
def test_parity_holds_when_the_next_group_refills_the_reference_buffer(
        tmp_path, monkeypatch, lengths, seeds, bit_depth, jax_mode):
    """The state and the order that lost these two parity cases now and
    then: the reference's pooled staging buffer is 64-byte aligned (a CPU
    put does not copy it), its groups are pipelined (one video each), and
    each group's program runs only after the next group's gather has
    refilled the buffer. The gate must still compare the port with a
    reference that tracked its own videos."""
    d = tmp_path / "v"
    for i, (n, seed) in enumerate(zip(lengths, seeds)):
        _write(d, f"nova-run-{i + 1}-001", n_frames=n, seed=seed,
               bit_depth=bit_depth)
    det = JaxDetectorConfig()
    band_rows = 2 * jax_band_margin(det.morphology_kernel_size,
                                    det.gaussian_sigma) + 1
    key = ("buf", (1, max(lengths), band_rows, 384 * bit_depth // 8))
    buf = _aligned_empty(key[1])
    monkeypatch.setattr(jax_fused, "_STAGING_POOL", {key: buf})
    monkeypatch.setattr(jax_fused, "_puts_are_lazy", lambda: False)
    program = jax_fused._fused_program
    monkeypatch.setattr(
        jax_fused, "_fused_program",
        lambda *a, **kw: lambda *args: _RunsAtFetch(program(*a, **kw), args))
    _check_against_both(d, tmp_path, jax_mode=jax_mode, monkeypatch=monkeypatch)
    assert jax_fused._STAGING_POOL[key] is buf  # every group staged through it


def test_port_library_reads_no_staging_buffer_after_releasing_it(tmp_path,
                                                                 monkeypatch):
    """The port's side of the same hazard: every staging buffer is
    overwritten the moment it goes back to the pool, as the next group's
    gather would, and the library run still equals both references."""
    release, refilled = port_fused.release_staging, []

    def release_and_refill(buf, event=None):
        buf.fill_(0xA5)
        refilled.append(buf.shape)
        release(buf, event)

    monkeypatch.setattr(port_fused, "release_staging", release_and_refill)
    d = tmp_path / "v"
    _write(d, "nova-run-1-001", seed=5, bit_depth=8)
    _write(d, "nova-run-2-001", n_frames=28, seed=6, bit_depth=8)
    _check_against_both(d, tmp_path)
    assert len(refilled) == 2  # one buffer a group, two groups


def test_mixed_shapes_one_group_per_shape_in_collection_order(tmp_path):
    d = tmp_path / "v"
    _write(d, "a-run-1-001", seed=1)
    _write(d, "b-run-1-001", seed=2, height=48, width=512, n_frames=30)
    _write(d, "c-run-1-001", seed=3, n_frames=27)
    _write(d, "d-run-1-001", seed=4, height=48, width=512, n_frames=30)
    got = _port_library(d)
    assert port_batch.LAST_GROUP_PATHS == ["fused", "fused"]
    ref = _jax_library(d)
    _assert_same(got, ref)
    _assert_same(got, _port_per_file(d))
    assert [o.total_frames for o in got] == [40, 30, 27, 30]


class _Len:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@settings(max_examples=200, deadline=None)
@given(lengths=st.lists(st.integers(0, 5000), min_size=1, max_size=12),
       w=st.sampled_from([64, 384, 1024]),
       budget=st.integers(0, 1 << 28))
def test_split_by_footprint_equals_original(lengths, w, budget):
    videos = [_Len(n) for n in lengths]
    idxs = list(range(len(videos)))
    assert (port_batch._split_by_footprint(idxs, videos, w, budget)
            == jax_batch._split_by_footprint(idxs, videos, w, budget))


@settings(max_examples=300, deadline=None)
@given(data=st.data(),
       v=st.integers(1, 5), n_max=st.integers(1, 70),
       thr=st.sampled_from(["0.7", "0.3", "1", "off", "0", "junk", "0.05"]))
def test_clip_ranges_equals_original(data, v, n_max, thr):
    import os

    lengths = data.draw(st.lists(st.integers(1, n_max), min_size=v, max_size=v))
    lengths[data.draw(st.integers(0, v - 1))] = n_max
    empty = np.ones((v, n_max), bool)
    for i, n in enumerate(lengths):
        a = data.draw(st.integers(0, n))
        b = data.draw(st.integers(a, n))
        empty[i, a:b] = False
        if data.draw(st.booleans()) and b > a:
            empty[i, data.draw(st.integers(a, b - 1))] = True
    old = os.environ.get("HSIP_CLIP_EMPTY")
    os.environ["HSIP_CLIP_EMPTY"] = thr
    try:
        got = port_fused._clip_ranges(empty, lengths, n_max)
        want = jax_fused._clip_ranges(empty, lengths, n_max)
    finally:
        if old is None:
            del os.environ["HSIP_CLIP_EMPTY"]
        else:
            os.environ["HSIP_CLIP_EMPTY"] = old
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_fused_group_count_routing(monkeypatch):
    count = port_fused._fused_group_count
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "4")
    assert count(8) == 4
    assert count(3) == 3  # clamped to V
    assert count(1) == 1
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "junk")
    assert count(8) == 1
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "auto")
    assert count(8) == 4
    assert count(3) == 3
    assert count(1) == 1
    monkeypatch.delenv("HSIP_FUSED_GROUPS")
    assert count(8) == 4
    # The forced counts agree with the original's (its auto rule asks the
    # link, which has no counterpart here).
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "3")
    for v in (1, 2, 3, 8):
        assert count(v) == jax_fused._fused_group_count(v, None)


def _dark_library(d):
    """Two recordings with ~60 % dark preambles, one that ends dark, and an
    all-dark rider."""
    for i, (n, ign, seed) in enumerate([(64, 40, 50), (64, 44, 51)]):
        _write(d, f"nova-run-{i + 1}-001", n_frames=n, seed=seed, ignition=ign,
               v0=384 / 30)
    dark = np.zeros((64, 64, 384), np.uint16)
    write_recording(d, "nova-run-3-001", dark,
                    spec=CihxSpec(width=384, height=64, total_frames=64,
                                  record_rate=100_000, bit_depth=12))
    # Dark preamble AND dark tail: the flame burns frames 30..44 only.
    flame = FlameSpec(x0=25.0, v0_px=384 / 30, accel_px=0.0, ignition_frame=30,
                      seed=52)
    frames, _ = synthesize_flame_video(64, height=64, width=384, flame=flame)
    frames[45:] = frames[0]
    write_recording(d, "nova-run-4-001", frames,
                    spec=CihxSpec(width=384, height=64, total_frames=64,
                                  record_rate=100_000, bit_depth=12))


def _counts(times):
    """The counters of a StageTimes, by name."""
    return {k[len("count."):]: v for k, v in times.as_dict().items()
            if k.startswith("count.")}


def test_clip_skips_dark_ranges_bit_identically(tmp_path, monkeypatch):
    d = tmp_path / "v"
    _dark_library(d)
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "1")
    times = StageTimes()
    clipped = _port_library(d, stage_times=times)
    assert port_batch.LAST_GROUP_PATHS == ["fused"]
    counts = _counts(times)
    assert counts["clipped_groups"] == 1, "a dark-preamble batch must take the clip"
    assert counts["frames_staged"] == 4 * 64
    assert counts["frames_copied"] < counts["frames_staged"]
    assert not clipped[2].rows  # the all-dark video records nothing
    assert clipped[3].rows and clipped[3].empty_frame_count >= 30
    monkeypatch.setenv("HSIP_CLIP_EMPTY", "off")
    times = StageTimes()
    full = _port_library(d, stage_times=times)
    counts = _counts(times)
    assert counts["clipped_groups"] == 0
    assert counts["frames_copied"] == counts["frames_staged"] == 4 * 64
    _assert_same(clipped, full)
    assert (_tables(port_pipeline, clipped, tmp_path / "on")
            == _tables(port_pipeline, full, tmp_path / "off"))
    monkeypatch.delenv("HSIP_CLIP_EMPTY")
    _assert_same(clipped, _jax_library(d))
    _assert_same(clipped, _port_per_file(d))
    # Grouped (G=4: one video a group): the preamble groups clip, each
    # alone, and the tables are the same again.
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "4")
    times = StageTimes()
    _assert_same(_port_library(d, stage_times=times), full)
    assert _counts(times)["clipped_groups"] > 0


def _stopped_at_the_cap(frames, band, cap):
    """Frames of one recording whose count, band rows first and then the
    other rows in order, reaches ``cap`` before the last row, under the
    fused library's noise rule (its background: frame 0's maximum)."""
    from hsip_tpu_torch.track.scan import NOISE_THRESHOLD_FLOOR

    bg = float(np.max(frames[0]))
    noise = max(NOISE_THRESHOLD_FLOOR, bg * 0.5)
    v = np.maximum(frames.astype(np.float32) - np.float32(bg), np.float32(0))
    rows = (v > np.float32(noise)).sum(2)
    band = sorted(set(int(r) for r in band))
    order = [rows[:, band].sum(1)] + [rows[:, r] for r in range(rows.shape[1])
                                      if r not in band]
    reached = np.cumsum(order, axis=0) >= cap
    return int(reached[:-1].any(axis=0).sum())


def test_capped_counts_decide_frames_as_the_exact_counts(tmp_path):
    """The fused library stops each frame's count at the cap
    (``empty_count_cap``). On a recording with a dark preamble and tail and
    one whose only signal lies outside the band rows, its rows, empty
    frames and tables equal the JAX library's and the port's per-file run's
    (both count every pixel), and the frames it stopped early are counted."""
    from hsip_tpu_torch.kernels.preprocess import band_margin, reflect_indices
    from hsip_tpu_torch.track.scan import MIN_SIGNAL_FRACTION

    d = tmp_path / "v"
    h, w, n = 64, 384, 40
    spec = CihxSpec(width=w, height=h, total_frames=n, record_rate=100_000,
                    bit_depth=12)
    det = FlameDetectorConfig()
    band = reflect_indices(h // 2, band_margin(det.morphology_kernel_size,
                                               det.gaussian_sigma), h)
    # Dark preamble and dark tail: the flame burns frames 12..29 only.
    flame = FlameSpec(x0=25.0, v0_px=w / 30, accel_px=0.0, ignition_frame=12,
                      seed=71)
    lit, _ = synthesize_flame_video(n, height=h, width=w, flame=flame)
    lit[30:] = lit[0]
    # Two dark frames with cap - 1 and cap bright pixels, the last on the
    # frame's last row: empty and not empty.
    cap = port_fused.empty_count_cap(h * w, MIN_SIGNAL_FRACTION)
    for f, k in ((33, cap - 1), (36, cap)):
        lit[f].reshape(-1)[np.linspace(0, h * w - 1, k).astype(int)] = 4000
    write_recording(d, "nova-run-1-001", lit, spec=spec)
    # Signal outside the band rows only: the band keeps frame 0's dark rows.
    flame = FlameSpec(x0=25.0, v0_px=w / 50, accel_px=0.0, ignition_frame=4,
                      seed=72)
    off_band, _ = synthesize_flame_video(n, height=h, width=w, flame=flame)
    off_band[:, band, :] = off_band[0, band, :]
    write_recording(d, "nova-run-2-001", off_band, spec=spec)

    got = _check_against_both(d, tmp_path)
    assert got[0].empty_frame_count == 12 + 10 - 1
    times = StageTimes()
    _assert_same(_port_library(d, stage_times=times), got)
    counts = _counts(times)
    assert counts["frames_counted"] == 2 * n
    assert counts["frames_count_capped"] == (_stopped_at_the_cap(lit, band, cap)
                                             + _stopped_at_the_cap(off_band, band, cap))
    assert 0 < counts["frames_count_capped"] < 2 * n


def test_clip_stands_down_on_a_dense_batch(tmp_path):
    d = tmp_path / "v"
    _write(d, "nova-run-1-001", seed=60)
    times = StageTimes()
    outs = _port_library(d, stage_times=times)
    assert outs[0].rows and port_batch.LAST_GROUP_PATHS == ["fused"]
    assert _counts(times)["clipped_groups"] == 0


@pytest.mark.parametrize("groups", ["1", "2", "4", "3"])
def test_pipelined_groups_identical_and_traced(tmp_path, monkeypatch, groups):
    d = tmp_path / "v"
    lengths = (40, 25, 33, 37, 29)
    for i, n in enumerate(lengths):
        _write(d, f"nova-run-{i + 1}-001", n_frames=n, seed=90 + i)
    monkeypatch.setenv("HSIP_FUSED_GROUPS", "1")
    one = _port_library(d)
    monkeypatch.setenv("HSIP_FUSED_GROUPS", groups)
    got = _port_library(d)
    assert port_batch.LAST_GROUP_PATHS == ["fused"]
    _assert_same(got, one)
    _assert_same(got, _port_per_file(d))
    trace = port_fused._LAST_PIPELINE_TRACE
    assert len(trace) == int(groups)
    for t in trace:
        assert (t["gather_start_t"] <= t["gather_end_t"] <= t["dispatch_t"]
                <= t["inputs_ready_t"] <= t["finals_ready_t"])
    for g in range(len(trace) - 1):
        # Group g is enqueued before group g+1's gather starts.
        assert trace[g]["dispatch_t"] <= trace[g + 1]["gather_start_t"]
        assert trace[g]["finals_ready_t"] <= trace[g + 1]["finals_ready_t"]
    # Results are fetched only after every group is enqueued.
    assert trace[0]["finals_ready_t"] >= trace[-1]["dispatch_t"]


def _fused_direct(d, det=None, sc=None):
    with hsip_tpu_torch.open_collection(str(d)) as coll:
        videos = list(coll)
        return port_fused.track_uniform_videos_fused(
            videos, videos[0].frame_shape[1], det or FlameDetectorConfig(), sc,
            True, device="cpu")


@pytest.mark.parametrize("why", ["skip_frames", "even_kernel_folding_band",
                                 "mixed_depths", "env_off", "budget_zero"])
def test_fused_declines_and_chunked_path_writes_the_same(tmp_path, monkeypatch, why):
    d = tmp_path / "v"
    det, sc = FlameDetectorConfig(), None
    height = 16 if why == "even_kernel_folding_band" else 64
    _write(d, "nova-run-1-001", seed=1, height=height)
    _write(d, "nova-run-2-001", seed=2, height=height, n_frames=30,
           bit_depth=16 if why == "mixed_depths" else 12)
    if why == "skip_frames":
        sc = _source(VideoSourceConfig, skip_frames=[3, 4])
    elif why == "even_kernel_folding_band":
        det = FlameDetectorConfig(morphology_kernel_size=4)
    elif why == "env_off":
        monkeypatch.setenv("HSIP_FUSED", "0")
    elif why == "budget_zero":
        monkeypatch.setattr(port_fused, "_fused_limit_bytes", lambda dev: 0)
    assert _fused_direct(d, det, sc) is None
    got = _port_library(d, det, source_config=sc)
    assert port_batch.LAST_GROUP_PATHS == ["chunked"]
    assert all(o.rows for o in got)
    jdet = JaxDetectorConfig(morphology_kernel_size=det.morphology_kernel_size)
    jsc = _source(JaxSourceConfig, skip_frames=[3, 4]) if sc else None
    ref = _jax_library(d, jdet, source_config=jsc)
    _assert_same(got, ref)
    assert (_tables(port_pipeline, got, tmp_path / "p")
            == _tables(jax_pipeline, ref, tmp_path / "j"))


def test_chunked_path_alone_equals_fused(tmp_path, monkeypatch):
    d = tmp_path / "v"
    for i, n in enumerate((40, 25, 33)):
        _write(d, f"nova-run-{i + 1}-001", n_frames=n, seed=70 + i)
    sc = _source(VideoSourceConfig, detection_method="half_maximum")
    for source in (None, sc):
        monkeypatch.setenv("HSIP_FUSED", "1")
        fused = _port_library(d, source_config=source)
        assert port_batch.LAST_GROUP_PATHS == ["fused"]
        monkeypatch.setenv("HSIP_FUSED", "0")
        chunked = _port_library(d, source_config=source, chunk_size=16)
        assert port_batch.LAST_GROUP_PATHS == ["chunked"]
        _assert_same(chunked, fused)


def test_small_group_budget_splits_into_sub_batches(tmp_path):
    d = tmp_path / "v"
    for i, n in enumerate((40, 25, 33)):
        _write(d, f"nova-run-{i + 1}-001", n_frames=n, seed=30 + i)
    whole = _port_library(d)
    split = _port_library(d, max_group_bytes=40 * 384 * 16)  # one video each
    assert port_batch.LAST_GROUP_PATHS == ["fused"] * 3
    _assert_same(split, whole)


def test_mesh_library_equals_the_unsharded_run(tmp_path):
    """A mesh library run (two CPU slots) equals the unsharded one, through
    the tracker and through the source runner, tables included."""
    from hsip_tpu_torch.parallel import make_mesh

    d = tmp_path / "v"
    _write(d, "nova-run-1-001")
    _write(d, "nova-run-2-001", n_frames=30, seed=4)
    _write(d, "nova-run-3-001", n_frames=35, seed=5)
    mesh = make_mesh("video", devices=["cpu", "cpu"])
    _assert_same(_port_library(d, mesh=mesh), _port_library(d))
    sc = _source(VideoSourceConfig)
    sc.video_path = str(d)
    tables = {}
    for tag, kw in (("mesh", dict(mesh=mesh)), ("single", dict(device="cpu"))):
        sc.output_dir = str(tmp_path / tag)
        outs = port_pipeline.process_video_source_library(sc, verbose=False, **kw)
        assert len(outs) == 3 and port_batch.LAST_GROUP_PATHS == ["fused"]
        tables[tag] = {p.name: p.read_bytes()
                       for p in sorted((tmp_path / tag).glob("*.txt"))}
    assert len(tables["mesh"]) >= 3 and tables["mesh"] == tables["single"]


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    d = tmp_path / "v"
    _write(d, "nova-run-1-001")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with hsip_tpu_torch.open_collection(str(d)) as coll:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_batch.track_collection_device(coll, FlameDetectorConfig())
        videos = list(coll)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_fused.track_uniform_videos_fused(
                videos, 384, FlameDetectorConfig(), None, True)


def test_fused_stage_attribution(tmp_path):
    d = tmp_path / "v"
    _write(d, "nova-run-1-001")
    _write(d, "nova-run-2-001", seed=9)
    times = StageTimes()
    outs = _port_library(d, stage_times=times)
    assert outs and all(o.rows for o in outs)
    stages = times.as_dict()
    for key in ("read_gather", "h2d", "device_dispatch", "d2h", "tables"):
        assert key in stages, stages
    assert "clip_copy" not in stages
    assert "counts_host" not in stages, stages


def test_cpu_library_run_launches_no_kernel(tmp_path, monkeypatch):
    from hsip_tpu_torch.kernels import _build
    from hsip_tpu_torch.kernels.cuda_preprocess import cuda_band_profiles
    from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU run must not build the CUDA kernels")

    monkeypatch.setattr(_build, "build_kernels", refuse)
    monkeypatch.setattr(cuda_band_profiles, "launches", 0)
    monkeypatch.setattr(cuda_tracking_scan, "launches", 0)
    d = tmp_path / "v"
    _write(d, "nova-run-1-001")
    _write(d, "nova-run-2-001", seed=9)
    for fused in ("1", "0"):
        monkeypatch.setenv("HSIP_FUSED", fused)
        assert all(o.rows for o in _port_library(d))
    assert cuda_band_profiles.launches == 0
    assert cuda_tracking_scan.launches == 0


def test_budget_counts_payload_band_lines_and_one_unpack():
    budget = port_fused._fused_budget_bytes
    n, w, b = 2048, 1024, 19
    whole = budget(8, n, w, b, 12, 1)
    piped = budget(8, n, w, b, 12, 4)
    payload = 8 * n * b * (w * 12 // 8)
    band_group = 2 * n * b * w * 4
    assert payload + band_group < piped < whole
    assert whole > payload + 8 * n * b * w * 4 + 6 * 8 * n * w * 4
    # 8-bit decodes with one cast: a smaller transient than 12-bit.
    assert budget(1, n, w, b, 8) < budget(1, n, w, b, 12)
    # One rule: half of the device's memory (the host's, for a CPU device).
    host = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    assert port_fused._fused_limit_bytes(torch.device("cpu")) == host // 2


def test_staging_pool_hands_a_buffer_to_one_user_and_stays_bounded(monkeypatch):
    monkeypatch.setattr(port_fused, "_STAGING_POOL", [])
    a = port_fused.take_staging((4, 8), pinned=False)
    b = port_fused.take_staging((4, 8), pinned=False)
    assert a.data_ptr() != b.data_ptr() and a.dtype == torch.uint8
    port_fused.release_staging(a)
    assert port_fused.take_staging((4, 8), pinned=False).data_ptr() == a.data_ptr()
    assert port_fused.take_staging((4, 8), pinned=False).data_ptr() != a.data_ptr()
    port_fused.release_staging(a)
    assert port_fused.take_staging((4, 9), pinned=False).shape == (4, 9)
    assert port_fused.take_staging((4, 8), torch.int32, pinned=False).dtype == torch.int32
    for i in range(7):
        port_fused.release_staging(torch.empty((i + 1,), dtype=torch.uint8))
    assert len(port_fused._STAGING_POOL) == port_fused._STAGING_POOL_MAX


def test_staging_pool_under_threads_never_shares_a_buffer(monkeypatch):
    """More workers than cores take, fill, check and release buffers of one
    shape: a buffer handed to two users at once would show another
    worker's fill."""
    import sys
    import threading

    monkeypatch.setattr(port_fused, "_STAGING_POOL", [])
    errors, done = [], []
    deadline = time.monotonic() + 5.0

    def worker(tag):
        while time.monotonic() < deadline and len(done) < 400:
            buf = port_fused.take_staging((64,), pinned=False)
            buf.fill_(tag)
            if not bool((buf == tag).all()):
                errors.append(tag)
            port_fused.release_staging(buf)
            done.append(tag)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i + 1,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(done) >= 400
    assert len(port_fused._STAGING_POOL) <= port_fused._STAGING_POOL_MAX
    ptrs = [e[1].data_ptr() for e in port_fused._STAGING_POOL]
    assert len(set(ptrs)) == len(ptrs)
