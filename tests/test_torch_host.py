"""The port's copies of the JAX package's host modules, held against their
originals.

``hsip_tpu_torch`` keeps its own copy of every host module it uses (the
MRAW codec, CIHX parsing, synthetic recordings, video objects, the float64
host ops and tracker, FITPACK, velocities, the host scan, the table writer,
``StageTimes`` and the figures). The same numpy-seeded inputs go through
each ``hsip_tpu`` function and its copy; the results must be equal (bytes,
arrays and rows, no tolerance).
"""

import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import hsip_tpu  # noqa: E402
import hsip_tpu_torch  # noqa: E402
from hsip_tpu import _native as jax_native  # noqa: E402
from hsip_tpu import io as jax_io  # noqa: E402
from hsip_tpu import pipeline as jax_pipeline  # noqa: E402
from hsip_tpu.kernels import reference as jax_ref  # noqa: E402
from hsip_tpu.track import detectors as jax_det  # noqa: E402
from hsip_tpu.track import fitpack as jax_fitpack  # noqa: E402
from hsip_tpu.track import scan as jax_scan  # noqa: E402
from hsip_tpu.track import velocity as jax_vel  # noqa: E402
from hsip_tpu.track.config import (  # noqa: E402
    FileCalibration as JaxFileCalibration,
)
from hsip_tpu.track.config import VideoSourceConfig as JaxSourceConfig  # noqa: E402
from hsip_tpu.utils.profiling import StageTimes as JaxStageTimes  # noqa: E402
from hsip_tpu_torch import _native as port_native  # noqa: E402
from hsip_tpu_torch import io as port_io  # noqa: E402
from hsip_tpu_torch import metadata as port_metadata  # noqa: E402
from hsip_tpu_torch import pipeline as port_pipeline  # noqa: E402
from hsip_tpu_torch.kernels import reference as port_ref  # noqa: E402
from hsip_tpu_torch.track import config as port_config  # noqa: E402
from hsip_tpu_torch.track import detectors as port_det  # noqa: E402
from hsip_tpu_torch.track import fitpack as port_fitpack  # noqa: E402
from hsip_tpu_torch.track import host_scan as port_scan  # noqa: E402
from hsip_tpu_torch.track import velocity as port_vel  # noqa: E402
from hsip_tpu_torch.utils.profiling import StageTimes as PortStageTimes  # noqa: E402

METHODS = ["combined", "threshold", "half_maximum", "gradient"]
DEPTHS = [8, 10, 12, 16]


def _frames(seed, n=6, h=16, w=40, depth=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << depth, (n, h, w)).astype(np.uint16)


def _same_tree(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


# ---- _native ----

def test_native_builds_into_the_port_build_dir():
    lib = port_native.build_library()
    assert lib.parent == Path(hsip_tpu_torch.__file__).parent / "build"
    assert lib.name.startswith("libmraw_decode-")


def test_native_build_follows_the_sources_digest(tmp_path, monkeypatch):
    """A library without a stamp, or whose stamp is not the digest of the
    current sources and g++ commands, is rebuilt from both sources, even
    when its mtime is newer than theirs; one whose stamp matches is loaded
    without a build."""
    import os
    import subprocess

    real = port_native.build_library()
    lib = tmp_path / real.name
    stamp = lib.with_name(lib.name + ".sha256")
    monkeypatch.setattr(port_native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_native, "_LIB", lib)
    builds = []

    def gxx(cmd, **kwargs):  # stands in for g++: "compiles" the real library
        builds.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(real.read_bytes())
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(port_native.subprocess, "run", gxx)
    newer = 3600 + max(port_native._SRC.stat().st_mtime,
                       port_native._SRC_FITPACK.stat().st_mtime)
    for stale_stamp in (None, "0" * 64):
        lib.write_bytes(b"a library of older sources")
        os.utime(lib, (newer, newer))
        if stale_stamp is None:
            stamp.unlink(missing_ok=True)
        else:
            stamp.write_text(stale_stamp + "\n")
        n_builds = len(builds)
        assert port_native.build_library() == lib
        assert len(builds) == n_builds + 1
        assert {str(port_native._SRC), str(port_native._SRC_FITPACK)} <= set(builds[-1])
        assert stamp.read_text().strip() == port_native._digest()
    decoder = port_native.NativeDecoder(port_native.build_library())
    assert len(builds) == 2
    assert decoder.count_path in ("avx512", "avx2", "scalar")
    assert not list(tmp_path.glob("*.tmp*"))


@pytest.mark.parametrize("depth", DEPTHS)
def test_native_codec_matches(depth):
    """Fused band gather + counts and the count pass, byte for byte."""
    jd, pd = jax_native.native_decoder(), port_native.native_decoder()
    frames = _frames(depth, n=5, h=12, w=64, depth=depth)
    packed = jax_io.mraw.pack_12bit(frames) if depth == 12 else (
        jax_io.mraw.pack_10bit(frames) if depth == 10 else (
            frames.astype(np.uint8) if depth == 8 else frames.view(np.uint8)))
    packed = np.ascontiguousarray(packed).reshape(-1)
    fbytes = packed.size // 5
    rows = np.array([2, 5, 9], dtype=np.int64) * (fbytes // 12)
    row_nbytes = fbytes // 12
    for d in (jd, pd):
        assert d.has_gather_count
    jb, jc = jd.gather_rows_count(packed, fbytes, rows, row_nbytes, 100.0, 50.0, depth)
    pb, pc = pd.gather_rows_count(packed, fbytes, rows, row_nbytes, 100.0, 50.0, depth)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(
        pd.gather_rows(packed, fbytes, rows, row_nbytes),
        jd.gather_rows(packed, fbytes, rows, row_nbytes))
    count = f"count_above_{depth}bit"
    np.testing.assert_array_equal(getattr(pd, count)(packed, fbytes, 100.0, 50.0),
                                  getattr(jd, count)(packed, fbytes, 100.0, 50.0))
    if depth in (10, 12):
        pack, unpack = f"pack_{depth}bit", f"unpack_{depth}bit"
        flat = frames.reshape(-1)
        np.testing.assert_array_equal(getattr(pd, pack)(flat), getattr(jd, pack)(flat))
        np.testing.assert_array_equal(getattr(pd, unpack)(packed), getattr(jd, unpack)(packed))


# ---- _native: the above-noise count, path by path ----

def _float_rule_counts(frames, background, threshold):
    """The count's rule as the float loop had it, in float32: a pixel counts
    when max(p - background, 0) > threshold."""
    v = frames.astype(np.float32) - np.float32(background)
    v = np.where(v < 0, np.float32(0), v)
    return (v > np.float32(threshold)).reshape(len(frames), -1).sum(1)


def _pack(frames, depth):
    flat = frames.reshape(-1)
    if depth == 12:
        return port_io.mraw.pack_12bit(flat)
    if depth == 10:
        return port_io.mraw.pack_10bit(flat)
    return flat.astype(np.uint8) if depth == 8 else flat.astype("<u2").view(np.uint8)


def _map_with_guard_page(path, nbytes):
    """``path``'s ``nbytes`` (whole pages) mapped read-only, with the page
    after them mapped with no access: a read past the last byte faults, as
    past the end of a recording's memory map. Returns (array, unmap)."""
    import ctypes
    import mmap

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    page = mmap.PAGESIZE
    assert nbytes % page == 0
    prot_none, map_fixed = 0, 0x10  # Linux
    base = libc.mmap(None, nbytes + page, prot_none,
                     mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS, -1, 0)
    assert base not in (None, ctypes.c_void_p(-1).value)
    with open(path, "rb") as f:
        addr = libc.mmap(base, nbytes, mmap.PROT_READ,
                         mmap.MAP_SHARED | map_fixed, f.fileno(), 0)
    assert addr == base
    arr = np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(addr))
    return arr, lambda: libc.munmap(base, nbytes + page)


@pytest.fixture(scope="module")
def count_decoders(tmp_path_factory):
    """The port's codec as built, and on x86-64 the same source rebuilt for
    AVX2 alone and for no vector extension, so that each 12-bit count path
    runs here whatever this host's build picks."""
    import platform
    import subprocess

    decoders = {"as built": port_native.native_decoder()}
    if platform.machine() != "x86_64":
        return decoders
    with open("/proc/cpuinfo") as f:
        avx2 = " avx2 " in next((line for line in f if line.startswith("flags")), "") + " "
    out = tmp_path_factory.mktemp("count-builds")
    for march, path in (("x86-64-v3", "avx2"), ("x86-64", "scalar")):
        if path == "avx2" and not avx2:
            continue
        lib = out / f"libmraw_decode-{march}.so"
        subprocess.run(["g++", "-O3", f"-march={march}", "-ffp-contract=off", "-shared",
                        "-fPIC", "-fopenmp", str(port_native._SRC),
                        str(port_native._SRC_FITPACK), "-o", str(lib)],
                       check=True, capture_output=True)
        decoders[path] = port_native.NativeDecoder(lib)
        assert decoders[path].count_path == path
    return decoders


# name: (frames, height, width, background(depth), threshold(depth))
_COUNT_CASES = {
    "fractional": (3, 7, 64, lambda d: 100.3, lambda d: 50.7),
    "threshold_on_a_code": (3, 7, 64, lambda d: 37.25, lambda d: 200 - 37.25),
    "negative_threshold": (3, 7, 64, lambda d: 10.0, lambda d: -5.0),
    "background_above_every_code": (3, 7, 64, lambda d: (1 << d) + 0.5, lambda d: 1.0),
    "nan_background": (3, 7, 64, lambda d: float("nan"), lambda d: 1.0),
    "nan_threshold": (3, 7, 64, lambda d: 10.0, lambda d: float("nan")),
    "ragged_frame_bytes": (3, 5, 132, lambda d: 100.3, lambda d: 50.7),
    "one_frame": (1, 16, 1024, lambda d: 0.5 * (1 << d), lambda d: 0.25 * (1 << d)),
    "mapped_to_the_end": (2, 8, 1024, lambda d: 100.3, lambda d: 50.7),
}


@pytest.mark.parametrize("case", sorted(_COUNT_CASES))
@pytest.mark.parametrize("depth", DEPTHS)
def test_count_paths_match_the_float_rule(count_decoders, tmp_path, depth, case):
    """Every count path of every build (the vector pass, the scalar integer
    loop, the fused gather+count) equals the float32 rule exactly."""
    n, h, w, bg_of, thr_of = _COUNT_CASES[case]
    bg, thr = bg_of(depth), thr_of(depth)
    frames = _frames(depth * 7 + len(case), n=n, h=h, w=w, depth=depth)
    edge = [0, 199, 200, 201, (1 << depth) - 1]  # codes around the rule's edges
    frames.reshape(n, -1)[:, :len(edge)] = edge
    packed = _pack(frames, depth)
    fbytes = packed.size // n
    unmap = None
    if case == "mapped_to_the_end":
        path = tmp_path / "payload.mraw"
        packed.tofile(path)
        packed, unmap = _map_with_guard_page(path, packed.size)
    want = _float_rule_counts(frames, bg, thr)
    rows = np.array([0, fbytes // h * (h - 1)], dtype=np.int64)
    try:
        for name, d in count_decoders.items():
            got = {
                "vector": getattr(d, f"count_above_{depth}bit")(packed, fbytes, bg, thr),
                "scalar": d.count_above_scalar(packed, fbytes, depth, bg, thr),
                "fused": d.gather_rows_count(packed, fbytes, rows, fbytes // h,
                                             bg, thr, depth)[1],
            }
            for path, counts in got.items():
                np.testing.assert_array_equal(counts, want, err_msg=f"{name}: {path}")
    finally:
        if unmap is not None:
            del packed
            unmap()


# ---- _native: the capped gather+count of the fused library ----

_CAP_H, _CAP_W, _CAP_N = 12, 64, 6
_CAP_BAND = [5, 6, 7]  # the band rows of most cases
_CAP_BG, _CAP_THR = 100.0, 50.0  # a pixel counts from code 151 on


def _cap_signal(case, rng):
    """(counting-pixel mask (n, h, w), band rows, cap) of one case."""
    n, h, w = _CAP_N, _CAP_H, _CAP_W
    mask = np.zeros((n, h, w), bool)
    band, cap = list(_CAP_BAND), 10
    outside = [r for r in range(h) if r not in band]
    if case == "random":
        mask = rng.random((n, h, w)) < rng.uniform(0.0, 0.03, (n, 1, 1))
    elif case == "inside_band":
        for f in range(n):
            mask[f, band] = rng.random((len(band), w)) < 0.02 * f
    elif case == "outside_band":
        for f in range(n):
            mask[f, outside] = rng.random((len(outside), w)) < 0.01 * f
    elif case == "last_pixel":
        mask[1::2, h - 1, w - 1] = True
        cap = 1
    elif case in ("cap_minus_1", "cap", "cap_plus_1"):
        k = cap + {"cap_minus_1": -1, "cap": 0, "cap_plus_1": 1}[case]
        for f in range(n):  # k pixels, the last of them on the last row
            flat = np.sort(rng.choice(h * w - 1, k - 1, replace=False))
            mask[f].reshape(-1)[np.append(flat, h * w - 1)] = True
    elif case == "folding_band":
        band = [2, 1, 0, 0, 1, 2, 3]  # a reflect band folding at row 0
        mask = rng.random((n, h, w)) < 0.004
    elif case == "cap_zero":
        mask = rng.random((n, h, w)) < 0.01
        cap = 0
    elif case == "cap_above_every_count":
        mask = rng.random((n, h, w)) < 0.5
        cap = h * w + 5
    return mask, np.array(band, np.int64), cap


def _capped_model(mask, band, cap):
    """The capped pass's counts and stopped frames, row by row in its
    order: the band's distinct rows run by run, then the other rows."""
    rows = mask.sum(2)
    h = rows.shape[1]
    distinct = sorted(set(band.tolist()))
    runs = [[r] for r in distinct[:1]]
    for r in distinct[1:]:
        if r == runs[-1][-1] + 1:
            runs[-1].append(r)
        else:
            runs.append([r])
    order = runs + [[r] for r in range(h) if r not in distinct]
    counts, stopped = [], 0
    for frame in rows:
        c, left = 0, h
        for run in order:
            if c >= cap:
                break
            c += int(frame[run].sum())
            left -= len(run)
        counts.append(min(c, cap))
        stopped += left > 0
    return np.array(counts), stopped


_CAP_CASES = ["random", "inside_band", "outside_band", "last_pixel", "cap_minus_1",
              "cap", "cap_plus_1", "folding_band", "cap_zero", "cap_above_every_count",
              "mapped_to_the_end"]


@pytest.mark.parametrize("case", _CAP_CASES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_capped_count_matches_the_exact_pass(count_decoders, tmp_path, depth, case):
    """Every build's capped pass copies the band rows of the exact fused
    pass byte for byte, counts min(exact, cap), decides every frame's
    count >= cap as the exact count does, and stops the frames it should."""
    rng = np.random.default_rng(depth * 31 + _CAP_CASES.index(case))
    mask, band, cap = _cap_signal("random" if case == "mapped_to_the_end" else case, rng)
    frames = rng.integers(0, 151, mask.shape).astype(np.uint16)
    frames[mask] = rng.integers(151, 1 << depth, int(mask.sum()))
    packed = _pack(frames, depth)
    fbytes = packed.size // _CAP_N
    rnb = fbytes // _CAP_H
    unmap = None
    if case == "mapped_to_the_end":  # whole pages, so the frames end where the map does
        pages = 4096 // np.gcd(4096, fbytes)
        frames = np.concatenate([frames] * pages)
        mask = np.concatenate([mask] * pages)
        packed = _pack(frames, depth)
        path = tmp_path / "payload.mraw"
        packed.tofile(path)
        packed, unmap = _map_with_guard_page(path, packed.size)
    want, want_stopped = _capped_model(mask, band, cap)
    try:
        for name, d in count_decoders.items():
            band_x, exact = d.gather_rows_count(
                packed, fbytes, band * rnb, rnb, _CAP_BG, _CAP_THR, depth)
            _band, _exact, none_stopped = d.gather_rows_capped_count(
                packed, fbytes, band * rnb, rnb, _CAP_BG, _CAP_THR, depth,
                np.iinfo(np.int32).max)
            band_c, capped, stopped = d.gather_rows_capped_count(
                packed, fbytes, band * rnb, rnb, _CAP_BG, _CAP_THR, depth, cap)
            assert none_stopped == 0, name
            np.testing.assert_array_equal(exact, mask.reshape(len(mask), -1).sum(1))
            np.testing.assert_array_equal(band_c, band_x, err_msg=name)
            np.testing.assert_array_equal(capped, np.minimum(exact, cap), err_msg=name)
            np.testing.assert_array_equal(capped >= cap, exact >= cap, err_msg=name)
            np.testing.assert_array_equal(capped, want, err_msg=name)
            assert stopped == want_stopped, name
    finally:
        if unmap is not None:
            del packed
            unmap()


@pytest.mark.parametrize("geometry", ["part_row", "part_pixel_group", "offset_mid_row"])
def test_fused_pass_refuses_rows_it_cannot_count(geometry):
    """The fused pass counts row by row, so it takes frames of whole rows of
    whole pixel groups with offsets on row starts, and refuses the rest."""
    d = port_native.native_decoder()
    fbytes, rnb, rows = {"part_row": (100, 30, [0]),
                         "part_pixel_group": (96, 8, [0]),
                         "offset_mid_row": (96, 24, [12])}[geometry]
    packed = np.zeros(2 * fbytes, np.uint8)
    with pytest.raises(ValueError):
        d.gather_rows_count(packed, fbytes, np.array(rows, np.int64), rnb, 1.0, 1.0, 12)


@pytest.mark.parametrize("depth", DEPTHS)
def test_band_bytes_and_counts_with_a_cap(tmp_path, depth):
    """The reader's fused pass: the exact pair, and its capped twin the
    same band, min(count, cap) and the frames that stopped early.
    PhotonVideo's pass, a copy of the original's, stays the exact one."""
    rng = np.random.default_rng(depth)
    frames = rng.integers(0, 1 << depth, (9, 16, 64)).astype(np.uint16)
    frames[:3] = 0  # dark frames are read whole
    spec = port_io.CihxSpec(width=64, height=16, total_frames=9,
                            record_rate=100_000, bit_depth=depth)
    meta = port_io.write_recording(tmp_path, f"run-{depth}-001", frames, spec=spec)
    rows = np.arange(6, 11, dtype=np.int32)
    with hsip_tpu_torch.open_video(str(meta)) as v:
        band, exact = v.band_bytes_and_counts(0, 9, rows, 10.0, 5.0)
        reader = v._require_reader()
        band_r, exact_r = reader.band_bytes_and_counts(0, 9, rows, 10.0, 5.0)
        _band, _exact, none_stopped = reader.band_bytes_and_capped_counts(
            0, 9, rows, 10.0, 5.0, np.iinfo(np.int32).max)
        band_c, capped, stopped = reader.band_bytes_and_capped_counts(
            0, 9, rows, 10.0, 5.0, 40)
    np.testing.assert_array_equal(band_r, band)
    np.testing.assert_array_equal(exact_r, exact)
    assert none_stopped == 0
    np.testing.assert_array_equal(band_c, band)
    np.testing.assert_array_equal(exact, _float_rule_counts(frames, 10.0, 5.0))
    np.testing.assert_array_equal(capped, np.minimum(exact, 40))
    assert stopped == int((exact[3:] >= 40).sum()) == 6


@pytest.mark.parametrize("depth", DEPTHS)
def test_uncapped_passes_return_the_references_pair(tmp_path, depth):
    """The decoder's, the reader's and the video's uncapped fused passes
    return what the JAX package's do: the same number of values, equal."""
    frames = _frames(depth + 3, n=7, h=16, w=64, depth=depth)
    spec = port_io.CihxSpec(width=64, height=16, total_frames=7,
                            record_rate=100_000, bit_depth=depth)
    meta = port_io.write_recording(tmp_path, f"run-{depth}-002", frames, spec=spec)
    rows = np.arange(5, 12, dtype=np.int64)
    packed = _pack(frames, depth)
    fbytes = packed.size // 7
    rnb = fbytes // 16
    jd, pd = jax_native.native_decoder(), port_native.native_decoder()
    with hsip_tpu_torch.open_video(str(meta)) as vp, hsip_tpu.open_video(str(meta)) as vj:
        pairs = {
            "decoder": (pd.gather_rows_count(packed, fbytes, rows * rnb, rnb, 40.0, 20.0, depth),
                        jd.gather_rows_count(packed, fbytes, rows * rnb, rnb, 40.0, 20.0, depth)),
            "reader": (vp._require_reader().band_bytes_and_counts(1, 7, rows, 40.0, 20.0),
                       vj._require_reader().band_bytes_and_counts(1, 7, rows, 40.0, 20.0)),
            "video": (vp.band_bytes_and_counts(1, 7, rows, 40.0, 20.0),
                      vj.band_bytes_and_counts(1, 7, rows, 40.0, 20.0)),
        }
    for where, (port, ref) in pairs.items():
        assert isinstance(port, tuple) and len(port) == len(ref) == 2, where
        for got, want in zip(port, ref):
            assert got.dtype == want.dtype, where
            np.testing.assert_array_equal(got, want, err_msg=where)


def test_empty_count_cap_is_the_least_non_empty_count():
    from hsip_tpu_torch.track.fused import empty_count_cap

    assert empty_count_cap(128 * 1024, port_scan.MIN_SIGNAL_FRACTION) == 66
    for h, w in ((40, 100), (64, 256)):
        cap = empty_count_cap(h * w, port_scan.MIN_SIGNAL_FRACTION)
        counts = np.arange(h * w + 1, dtype=np.int64)
        # the fused library's rule (track/fused.py, group_meta), verbatim
        empty = counts / float(h * w) < port_scan.MIN_SIGNAL_FRACTION
        np.testing.assert_array_equal(empty, counts < cap)
        np.testing.assert_array_equal(empty, np.minimum(counts, cap) / float(h * w)
                                      < port_scan.MIN_SIGNAL_FRACTION)
    assert empty_count_cap(64, 0.0) == 0
    assert empty_count_cap(64, 1.5) is None


# ---- io: synthetic recordings, CIHX parse, MRAW decode ----

@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("fmt", ["cihx", "cih"])
def test_synthetic_recordings_byte_identical(tmp_path, depth, fmt):
    flame = dict(x0=20.0, v0_px=5.0, accel_px=0.2, ddt_frame=9, v_jump_px=7.0,
                 ignition_frame=2, seed=depth)
    fj, pj = jax_io.synthesize_flame_video(
        14, height=24, width=96, flame=jax_io.FlameSpec(**flame), bit_depth=depth)
    fp, pp = port_io.synthesize_flame_video(
        14, height=24, width=96, flame=port_io.FlameSpec(**flame), bit_depth=depth)
    np.testing.assert_array_equal(fp, fj)
    np.testing.assert_array_equal(pp, pj)
    spec = dict(width=96, height=24, total_frames=14, record_rate=50_000,
                bit_depth=depth, start_frame=-3, comment="parity")
    mj = jax_io.write_recording(tmp_path / "jax", "rec-1", fj,
                                spec=jax_io.CihxSpec(**spec), metadata_format=fmt)
    mp = port_io.write_recording(tmp_path / "port", "rec-1", fp,
                                 spec=port_io.CihxSpec(**spec), metadata_format=fmt)
    assert mp.name == mj.name
    _same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("fmt", ["cihx", "cih"])
def test_cihx_parse_matches(tmp_path, fmt):
    spec = jax_io.CihxSpec(width=128, height=32, total_frames=9, record_rate=75_000,
                           bit_depth=10, start_frame=-4, skip_frame=2,
                           trigger_frame=3, irig=1, comment="header <&> parity")
    meta = jax_io.write_recording(tmp_path, "hdr-run-7", _frames(1, 9, 32, 128, 10),
                                  spec=spec, metadata_format=fmt)
    assert port_io.read_header(meta) == jax_io.read_header(meta)
    if fmt == "cihx":
        assert port_io.read_cihx_header(meta) == jax_io.read_cihx_header(meta)
        assert port_io.parse_cihx_xml(meta) == jax_io.parse_cihx_xml(meta)
        assert port_io.extract_cihx_xml_bytes(meta) == jax_io.extract_cihx_xml_bytes(meta)
    else:
        assert port_io.read_cih_header(meta) == jax_io.read_cih_header(meta)
    assert port_io.find_mraw_payload(meta) == jax_io.find_mraw_payload(meta)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_mraw_decode_matches(tmp_path, depth, native):
    frames = _frames(depth + 1, n=7, h=16, w=64, depth=depth)
    path = jax_io.write_mraw(tmp_path / "p.mraw", frames, bit_depth=depth)
    jr = jax_io.MRAWReader(path, 64, 16, depth, use_native=native)
    pr = port_io.MRAWReader(path, 64, 16, depth, use_native=native)
    try:
        assert (pr._native is not None) == (jr._native is not None) == native
        np.testing.assert_array_equal(pr.read_frames(slice(0, 7)), frames)
        np.testing.assert_array_equal(pr.read_frames(slice(1, 6)),
                                      jr.read_frames(slice(1, 6)))
        np.testing.assert_array_equal(pr.read_frame(3), jr.read_frame(3))
        np.testing.assert_array_equal(pr.count_above(0, 7, 300.0, 20.0),
                                      jr.count_above(0, 7, 300.0, 20.0))
        rows = np.array([3, 8, 12], dtype=np.int32)
        if jr.row_nbytes is not None:
            np.testing.assert_array_equal(pr.band_bytes(1, 6, rows),
                                          jr.band_bytes(1, 6, rows))
    finally:
        jr.close()
        pr.close()
    for pack, unpack in ((port_io.pack_12bit, port_io.unpack_12bit),
                         (port_io.pack_10bit, port_io.unpack_10bit)):
        flat = _frames(9, 1, 4, 40, 10).reshape(-1)
        jpack = getattr(jax_io, pack.__name__)
        assert np.array_equal(pack(flat), jpack(flat))
        assert np.array_equal(unpack(pack(flat)), getattr(jax_io, unpack.__name__)(jpack(flat)))


# ---- metadata, video ----

def test_metadata_config_matches():
    raw = {"Record Rate(fps)": 1000, "Total Frame": 10, "Image Width": 8,
           "Image Height": 4, "Comment": "x", "Shutter Speed(s)": 1e-5,
           "Date": "2026/1/1", "Device Name": "cam", "unknown": 3}
    for name in ("minimal", "full", "for_processing"):
        a = getattr(port_metadata.MetadataConfig, name)()
        b = getattr(hsip_tpu.MetadataConfig, name)()
        assert a.fields == b.fields
        assert a.filter_metadata(raw) == b.filter_metadata(raw)


def test_video_matches(flame_recording):
    path = str(flame_recording["path"])
    cal_p = hsip_tpu_torch.SpatialCalibration(scale=0.001, units="m")
    cal_j = hsip_tpu.SpatialCalibration(scale=0.001, units="m")
    with hsip_tpu_torch.open_video(path, trigger_frame=4, calibration=cal_p) as vp, \
            hsip_tpu.open_video(path, trigger_frame=4, calibration=cal_j) as vj:
        assert vp.describe() == vj.describe()
        assert (len(vp), vp.frame_shape, vp.frame_rate, vp.bit_depth) == \
            (len(vj), vj.frame_shape, vj.frame_rate, vj.bit_depth)
        for i in (0, 5, len(vj) - 1):
            assert vp.get_time(i) == vj.get_time(i)
            assert vp.get_absolute_time(i) == vj.get_absolute_time(i)
            assert vp.get_datetime(i) == vj.get_datetime(i)
        assert vp.pixels_to_physical(17.0) == vj.pixels_to_physical(17.0)
        np.testing.assert_array_equal(vp[3:9], vj[3:9])
        np.testing.assert_array_equal(vp.read_batch(0, 4), vj.read_batch(0, 4))
        rows = np.arange(28, 37, dtype=np.int32)
        np.testing.assert_array_equal(vp.band_bytes(2, 9, rows), vj.band_bytes(2, 9, rows))
        band_p, cnt_p = vp.band_bytes_and_counts(2, 9, rows, 60.0, 30.0)
        band_j, cnt_j = vj.band_bytes_and_counts(2, 9, rows, 60.0, 30.0)
        np.testing.assert_array_equal(band_p, band_j)
        np.testing.assert_array_equal(cnt_p, cnt_j)
        assert vp.staging_paths()[3] == vj.staging_paths()[3]


# ---- kernels/reference, detectors ----

def test_reference_ops_match():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 4000, (24, 50))
    prior = rng.uniform(0, 4000, (24, 50))
    nxt = rng.uniform(0, 4000, (24, 50))
    checks = [
        ("reflect_pad", (img, (2, 3))),
        ("grey_erosion", (img, (3, 3))),
        ("grey_dilation", (img, (4, 2))),
        ("grey_opening", (img, (3, 3))),
        ("grey_opening", (img, (2, 2))),
        ("gaussian_kernel1d", (1.5,)),
        ("gaussian_filter", (img, 1.5)),
        ("sobel", (img, 1)),
        ("sobel", (img, 0)),
        ("gradient_x", (img,)),
        ("subtract_scalar_background", (img, 900.0)),
        ("subtract_prior_frame", (img, prior, 5.0)),
        ("three_frame_difference", (prior, img, nxt, 5.0)),
        ("correlate1d_reflect", (img, np.array([0.25, 0.5, 0.25]), 1)),
    ]
    for name, args in checks:
        np.testing.assert_array_equal(getattr(port_ref, name)(*args),
                                      getattr(jax_ref, name)(*args), err_msg=name)
    assert port_ref.is_empty_frame(img, 3000.0, 0.1) == jax_ref.is_empty_frame(img, 3000.0, 0.1)


@pytest.mark.parametrize("method", ["threshold", "half_maximum", "gradient"])
def test_detectors_match(method):
    rng = np.random.default_rng(METHODS.index(method))
    cfg_p, cfg_j = port_config.FlameDetectorConfig(), jax_det.FlameDetectorConfig()
    for t in range(60):
        prof = np.abs(rng.normal(40, 30, 120))
        prof[rng.integers(10, 100):][:4] = prof.max()
        lo = int(rng.integers(0, 110))
        bounds = (lo, int(rng.integers(lo + 1, 121))) if t % 3 else None
        assert port_det.detect_profile(prof, method, cfg_p, bounds) == \
            jax_det.detect_profile(prof, method, cfg_j, bounds), t


# ---- track/config ----

def test_source_config_matches():
    kw = dict(name="S", calibration=0.002, position_offset=0.1)
    cals = [("0.001", "0.5", ["run-1-"]), ("0.003", "0.0", ["3:5"])]
    p = port_config.VideoSourceConfig(**kw)
    j = JaxSourceConfig(**kw)
    p.file_calibrations = [port_config.FileCalibration(float(c), float(o), f) for c, o, f in cals]
    j.file_calibrations = [JaxFileCalibration(float(c), float(o), f) for c, o, f in cals]
    for name in ("a-run-1-001.cihx", "shot-4.cihx", "shot-9.cihx", "x.cihx"):
        assert p.get_calibration_for_file(name) == j.get_calibration_for_file(name)
        assert p.has_calibration_for_file(name) == j.has_calibration_for_file(name)
    assert dataclasses.asdict(port_config.FlameDetectorConfig()) == \
        dataclasses.asdict(jax_det.FlameDetectorConfig())


# ---- fitpack / spline ----

@pytest.mark.parametrize("route", ["native", "python"])
def test_curfit_splev_match(monkeypatch, route):
    if route == "python":
        def refuse():
            raise RuntimeError("no toolchain")

        monkeypatch.setattr(jax_native, "native_decoder", refuse)
        monkeypatch.setattr(port_native, "native_decoder", refuse)
    rng = np.random.default_rng(11)
    for m, k, s in ((12, 3, 5.0), (30, 3, 40.0), (30, 2, 0.0), (8, 1, 2.0)):
        x = np.cumsum(rng.integers(1, 4, m)).astype(np.float64)
        y = 0.4 * x ** 1.3 + rng.normal(0, 2.0, m)
        w = rng.uniform(0.5, 2.0, m)
        tp, cp, fpp, ierp = port_fitpack.curfit(x, y, k=k, s=s, w=w)
        tj, cj, fpj, ierj = jax_fitpack.curfit(x, y, k=k, s=s, w=w)
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_array_equal(cp, cj)
        assert (fpp, ierp) == (fpj, ierj)
        xq = np.linspace(x[0], x[-1], 57)
        np.testing.assert_array_equal(port_fitpack.splev(xq, tp, cp, k),
                                      jax_fitpack.splev(xq, tj, cj, k))


# ---- velocity helpers ----

def test_velocity_helpers_match():
    rng = np.random.default_rng(8)
    frames = np.cumsum(rng.integers(1, 3, 40))
    pos = np.cumsum(rng.integers(0, 9, 40))
    entries = [(int(f), None if rng.random() < 0.15 else int(p)) for f, p in zip(frames, pos)]
    for fr, cal in ((100_000.0, 0.001), (0.0, 0.001), (20_000.0, 0.0005)):
        vp = port_vel.velocity_entries_from_positions(entries, fr, cal)
        vj = jax_vel.velocity_entries_from_positions(entries, fr, cal)
        assert vp == vj
        assert [list(map(list, x)) for x in port_vel.iter_velocity_entries(entries, fr, cal)] == \
            [list(map(list, x)) for x in jax_vel.iter_velocity_entries(entries, fr, cal)]
        for jump in (50.0, 1e9):
            assert port_vel.ddt_frame_from_velocities(vp, jump) == \
                jax_vel.ddt_frame_from_velocities(vj, jump)
        for clear in {-1, len(vj) // 2 if vj else -1, len(vj) - 1}:
            assert port_vel.velocities_from_positions(entries, fr, cal, clear) == \
                jax_vel.velocities_from_positions(entries, fr, cal, clear)


# ---- host scan, tracker, exact backend, table writer ----

def _recording_profiles(frames, module, config):
    n, h, w = frames.shape
    return module._compute_profiles_host_exact(
        lambda a, b: frames[a:b], n, (h, w), float(frames[0].max()), config,
        skip_frames=(5,))


@pytest.fixture(scope="module")
def ddt_frames():
    flame = jax_io.FlameSpec(x0=20.0, v0_px=4.0, ddt_frame=18, v_jump_px=22.0,
                             ignition_frame=3, seed=11)
    return jax_io.synthesize_flame_video(40, height=32, width=256, flame=flame)[0]


@pytest.mark.parametrize("use_frame_diff", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_host_scan_rows_match(ddt_frames, method, use_frame_diff):
    """Profiles, rows, velocity history, DDT and the spline predictions
    of the viz hook, from the port's host scan and the original."""
    cfg_p, cfg_j = port_config.FlameDetectorConfig(), jax_det.FlameDetectorConfig()
    pp = _recording_profiles(ddt_frames, port_scan, cfg_p)
    pj = _recording_profiles(ddt_frames, jax_scan, cfg_j)
    for f in dataclasses.fields(pj):
        np.testing.assert_array_equal(getattr(pp, f.name), getattr(pj, f.name))
    hooks = {"port": [], "jax": []}
    outs = {}
    for key, mod, prof, cfg in (("port", port_scan, pp, cfg_p), ("jax", jax_scan, pj, cfg_j)):
        outs[key] = mod.run_tracking_scan(
            prof, cfg, 100_000.0, 0.0008, position_offset_m=0.3,
            on_result=lambda r, t, k=key: hooks[k].append(
                (r.frame_idx, r.final_position, r.search_bounds, r.pos_spline_predicted)),
            detection_method=method, use_frame_diff=use_frame_diff)
    op, oj = outs["port"], outs["jax"]
    assert op.rows == oj.rows and len(oj.rows) > 3
    assert hooks["port"] == hooks["jax"]
    assert (op.empty_frame_count, op.break_frame, op.break_reason) == \
        (oj.empty_frame_count, oj.break_frame, oj.break_reason)
    assert op.tracker.get_velocity_history() == oj.tracker.get_velocity_history()
    assert op.tracker.ddt_frame == oj.tracker.ddt_frame
    assert op.merged_rows() == oj.merged_rows()
    assert pp.select_intensity(method, use_frame_diff)[1].tolist() == \
        pj.select_intensity(method, use_frame_diff)[1].tolist()


@pytest.mark.parametrize("method", METHODS)
def test_exact_backend_matches(flame_recording, method):
    def cfg(module_cfg):
        return module_cfg(name="S", detection_method=method, skip_frames=[6],
                          calibration=0.0008, position_offset=0.5)

    det_p, det_j = port_config.FlameDetectorConfig(), jax_det.FlameDetectorConfig()
    path = str(flame_recording["path"])
    with hsip_tpu_torch.open_video(path) as vp, hsip_tpu.open_video(path) as vj:
        bg = float(np.max(vj[0]))
        op = port_pipeline._track_video_exact(vp, det_p, 0.0008, 0.5,
                                              cfg(port_config.VideoSourceConfig), bg)
        oj = jax_pipeline._track_video_exact(vj, det_j, 0.0008, 0.5, cfg(JaxSourceConfig), bg)
    assert op.rows == oj.rows and len(oj.rows) > 5
    assert op.merged_rows() == oj.merged_rows()
    assert (op.empty_frame_count, op.break_reason) == (oj.empty_frame_count, oj.break_reason)


def test_ddt_split_tables_byte_identical(ddt_frames, tmp_path):
    cfg_p, cfg_j = port_config.FlameDetectorConfig(), jax_det.FlameDetectorConfig()
    op = port_scan.run_tracking_scan(_recording_profiles(ddt_frames, port_scan, cfg_p),
                                     cfg_p, 100_000.0, 0.0008, 0.3)
    oj = jax_scan.run_tracking_scan(_recording_profiles(ddt_frames, jax_scan, cfg_j),
                                    cfg_j, 100_000.0, 0.0008, 0.3)
    assert oj.tracker.ddt_detected
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    paths_p = port_pipeline._write_ddt_split_tables(op, tmp_path / "port", "r-1", False)
    paths_j = jax_pipeline._write_ddt_split_tables(oj, tmp_path / "jax", "r-1", False)
    assert sorted(paths_p) == sorted(paths_j) == ["all", "post_ddt", "pre_ddt"]
    _same_tree(tmp_path / "jax", tmp_path / "port")
    rows = [(1, 0.5, 3, 0.25, None, 2.5, None)]
    port_pipeline.write_position_results(rows, tmp_path / "p.txt")
    jax_pipeline.write_position_results(rows, tmp_path / "j.txt")
    assert filecmp.cmp(tmp_path / "p.txt", tmp_path / "j.txt", shallow=False)
    assert port_pipeline.RESULT_COLUMNS == jax_pipeline.RESULT_COLUMNS


def test_unmatched_calibration_warning_matches(capsys):
    cfg_p = port_config.VideoSourceConfig(name="S")
    cfg_j = JaxSourceConfig(name="S")
    cfg_p.file_calibrations = [port_config.FileCalibration(0.001, 0.0, ["zzz"])]
    cfg_j.file_calibrations = [JaxFileCalibration(0.001, 0.0, ["zzz"])]
    port_pipeline._warn_unmatched_calibration(cfg_p, "run-1.cihx")
    printed_p = capsys.readouterr().out
    jax_pipeline._warn_unmatched_calibration(cfg_j, "run-1.cihx")
    assert printed_p == capsys.readouterr().out != ""


# ---- StageTimes ----

def test_stage_times_match():
    tp, tj = PortStageTimes(), JaxStageTimes()
    for t in (tp, tj):
        t.add("h2d", 0.125)
        t.add("h2d", 0.25)
        t.add("read_gather", 1.0 / 3.0)
        assert t.wrap("scan", lambda a, b=2: a * b)(21) == 42
        with t.stage("drain"):
            pass
    dp, dj = tp.as_dict(), tj.as_dict()
    assert list(dp) == list(dj) == ["drain", "h2d", "read_gather", "scan"]
    assert (dp["h2d"], dp["read_gather"]) == (dj["h2d"], dj["read_gather"]) == (0.375, 0.3333)
    assert tp.as_dict(2)["read_gather"] == tj.as_dict(2)["read_gather"]


# ---- viz ----

def test_figures_byte_identical(flame_recording, tmp_path):
    """A compact diagnostic and a stacked sequence, rendered by each
    package's figure module from the same inputs, give the same PNG bytes."""
    pytest.importorskip("matplotlib")
    from hsip_tpu import viz as jax_viz
    from hsip_tpu_torch import viz as port_viz

    path = str(flame_recording["path"])
    cfg_j, cfg_p = jax_det.FlameDetectorConfig(), port_config.FlameDetectorConfig()
    task = dict(frame_idx=6, time_s=6e-5, pos_min_gradient=80, pos_rightmost_sobel=82,
                pos_spline_predicted=None, search_bounds=(60, 140), final_position=82,
                prior_frame_idx=5)
    entries = [(f, 40 + 7 * f) for f in range(2, 12)]
    for key, viz, cfg, video_mod in (("jax", jax_viz, cfg_j, hsip_tpu),
                                     ("port", port_viz, cfg_p, hsip_tpu_torch)):
        out = tmp_path / key
        viz.render_diagnostics_parallel(path, [task], entries, 80_000.0, 0.001, 60.0,
                                        out, "S", cfg, workers=1, style="compact")
        with video_mod.open_video(path) as v:
            viz.generate_stacked_sequence_single_column(
                v, [2, 6, 10], 60.0, out / "stacked.png", title="S")
    _same_tree(tmp_path / "jax", tmp_path / "port")
    assert len(list((tmp_path / "port").iterdir())) == 2


# --- collection, checkpoint, summary, logging: the cases of
# tests/test_collection.py and tests/test_utils.py that apply, run on both
# packages and held against each other ---

import json  # noqa: E402
import logging  # noqa: E402

from hsip_tpu import utils as jax_utils  # noqa: E402
from hsip_tpu_torch import utils as port_utils  # noqa: E402

_BOTH = [pytest.param(hsip_tpu, jax_io, jax_utils, id="jax"),
         pytest.param(hsip_tpu_torch, port_io, port_utils, id="port")]


@pytest.fixture(scope="module")
def collection_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collection")
    all_frames = []
    for i, n in enumerate([5, 8, 3]):
        frames, _ = port_io.synthesize_flame_video(n, height=32, width=128,
                                                   bit_depth=12)
        frames = frames.copy()
        frames[:, 0, 0] = i * 100 + np.arange(n)  # identity tag per video
        spec = port_io.CihxSpec(width=128, height=32, total_frames=n,
                                record_rate=10_000)
        port_io.write_recording(tmp, f"run-{i + 1}-video", frames, spec=spec)
        all_frames.append(frames)
    (tmp / "notes.txt").write_text("not a video")
    return tmp, all_frames


def _collection_facts(pkg, tmp, all_frames):
    """Everything tests/test_collection.py asks of a collection, as data."""
    facts = {}
    with pkg.VideoCollection.from_directory(tmp, pattern="*.cihx") as coll:
        facts["len"] = (len(coll), coll.total_frames, [len(v) for v in coll],
                        [p.name for p in coll.filepaths])
        facts["g2l"] = [coll.global_to_local(i) for i in (0, 4, 5, 12, 13, -1)]
        facts["l2g"] = [coll.local_to_global(1, 0), coll.local_to_global(2, 2)]
        for bad in (lambda: coll.global_to_local(16),
                    lambda: coll.local_to_global(5, 0)):
            with pytest.raises(IndexError):
                bad()
        np.testing.assert_array_equal(coll.get_global_frame(5), all_frames[1][0])
        np.testing.assert_array_equal(coll.get_global_frame(15), all_frames[2][2])
        facts["time"] = coll.get_global_time(5)
        facts["tags"] = coll.map_frames(lambda fr, vi, fi: (vi, fi, int(fr[0, 0])))
        facts["sub"] = coll.map_frames(lambda fr, vi, fi: int(fr[0, 0]),
                                       frame_indices=[5, 13])
        facts["sub_v"] = coll.map_frames(lambda fr, vi, fi: vi, video_indices=[2])
        facts["iter"] = [(vi, fi, t) for _f, vi, fi, t in coll.iter_frames()]
        plan = coll.batch_plan()
        facts["plan"] = (plan["max_frames"], plan["max_height"], plan["max_width"],
                         plan["lengths"].tolist(), plan["pad_mask"].tolist())
        facts["summary"] = coll.summary()
        facts["repr"] = repr(coll)
    return facts


def test_collection_matches(collection_dir):
    tmp, all_frames = collection_dir
    port = _collection_facts(hsip_tpu_torch, tmp, all_frames)
    assert port == _collection_facts(hsip_tpu, tmp, all_frames)
    assert port["len"][:3] == (3, 16, [5, 8, 3])
    assert port["g2l"] == [(0, 0), (0, 4), (1, 0), (1, 7), (2, 0), (2, 2)]
    assert port["l2g"] == [5, 15] and port["sub"] == [100, 200]
    assert port["plan"][:4] == (8, 32, 128, [5, 8, 3])


@pytest.mark.parametrize("pkg,io,utils", _BOTH)
def test_collection_constructors_and_setters(collection_dir, tmp_path, capsys,
                                             pkg, io, utils):
    tmp, _ = collection_dir
    files = sorted(tmp.glob("*.cihx"))
    coll = pkg.VideoCollection.from_files(files)
    assert coll.set_calibration_all(0.002).set_trigger_frame_all(1) is coll
    assert all(v.calibration.scale == 0.002 and v.trigger_frame == 1 for v in coll)
    coll.close_all()
    c1, c2 = pkg.open_collection(str(tmp)), pkg.open_collection([str(f) for f in files])
    assert len(c1) == len(c2) == 3
    c1.close_all()
    c2.close_all()
    with pytest.raises(ValueError):
        pkg.open_collection(42)
    with pytest.raises(FileNotFoundError):
        pkg.VideoCollection.from_directory(tmp_path / "nope")
    # A corrupt header warns and is skipped.
    frames, _ = io.synthesize_flame_video(3, height=32, width=128)
    io.write_recording(tmp_path, "good", frames)
    (tmp_path / "bad.cihx").write_bytes(b"corrupt")
    with pkg.VideoCollection.from_directory(tmp_path) as only_good:
        assert len(only_good) == 1
    assert "Warning" in capsys.readouterr().out
    # recursive=True finds nested directories; the default does not.
    io.write_recording(tmp_path / "shot-B", "run-9-video", frames)
    with pkg.VideoCollection.from_directory(str(tmp_path)) as flat:
        assert len(flat) == 1
    with pkg.VideoCollection.from_directory(str(tmp_path), recursive=True) as deep:
        assert len(deep) == 2


@pytest.mark.parametrize("pkg,io,utils", _BOTH)
def test_batch_checkpoint_roundtrip(tmp_path, pkg, io, utils):
    ckpt_cls = utils.BatchCheckpoint
    ckpt = ckpt_cls(tmp_path, run_config_hash="abc")
    assert not ckpt.is_done("a.cihx")
    ckpt.mark_done("a.cihx", rows=5)
    again = ckpt_cls(tmp_path, run_config_hash="abc")
    assert again.is_done("a.cihx") and again.completed["a.cihx"]["rows"] == 5
    assert not ckpt_cls(tmp_path, run_config_hash="DIFFERENT").is_done("a.cihx")
    (tmp_path / ckpt_cls.FILENAME).write_text("{broken")
    assert not ckpt_cls(tmp_path, run_config_hash="abc").is_done("a.cihx")
    # clear() removes every rank's ledger.
    for r in range(3):
        ckpt_cls(tmp_path, run_config_hash="h", rank=r).mark_done(f"v{r}")
    fresh = ckpt_cls(tmp_path, run_config_hash="h", rank=0)
    assert fresh.is_done("v1")  # sees other ranks' ledgers
    fresh.clear()
    assert not any(tmp_path.glob("hsip-checkpoint*.json"))
    assert not ckpt_cls(tmp_path, run_config_hash="h").is_done("v1")


def test_checkpoint_ledgers_interchangeable(tmp_path):
    """A ledger one package wrote is read by the other: same file name,
    same schema."""
    assert port_utils.BatchCheckpoint.FILENAME == jax_utils.BatchCheckpoint.FILENAME
    jax_utils.BatchCheckpoint(tmp_path, run_config_hash="x").mark_done("a", rows=2)
    port = port_utils.BatchCheckpoint(tmp_path, run_config_hash="x")
    assert port.is_done("a") and port.completed["a"]["rows"] == 2
    port.mark_done("b", rows=3)
    assert jax_utils.BatchCheckpoint(tmp_path, run_config_hash="x").is_done("b")


def test_run_summary_matches(ddt_frames, tmp_path):
    """The same outputs and failures give the same summary JSON in both
    packages (apart from the clock)."""
    frames, rate = ddt_frames, 100_000.0
    docs = []
    for tag, utils, scan, cfg_cls, det_cls in (
            ("jax", jax_utils, jax_scan, JaxSourceConfig, jax_det.FlameDetectorConfig),
            ("port", port_utils, port_scan, port_config.VideoSourceConfig,
             port_config.FlameDetectorConfig)):
        det = det_cls()
        profiles = scan._compute_profiles_host_exact(
            lambda a, b: frames[a:b], len(frames), frames.shape[1:],
            float(frames[0].max()), det)
        out = scan.run_tracking_scan(profiles, det, rate, 0.0008, 0.1)
        out.total_frames = len(frames)
        out.phase_timings = {"map_s": 0.1, "scan_s": 0.2}
        summary = utils.RunSummary("S", config_echo={
            "source": cfg_cls(name="S"), "detector": det, "backend": "x"})
        assert not summary.dirty
        summary.add_file("a.cihx", out, 0.0008, 0.1, 0.5, len(frames))
        summary.add_failure("b.cihx", ValueError("bad header"))
        assert summary.dirty
        path = summary.write(tmp_path / tag)
        assert path.name == "run-summary.json"
        doc = json.loads(path.read_text())
        # Seeding a new summary from the written one keeps the records;
        # a retried file replaces its failure.
        again = utils.RunSummary("S")
        again.seed_from(tmp_path / tag)
        again.add_file("b.cihx", out, 0.0008, 0.1, 0.5, len(frames))
        doc2 = json.loads(again.write(tmp_path / tag).read_text())
        assert [f["file"] for f in doc2["files"]] == ["a.cihx", "b.cihx"]
        assert not doc2["failures"]
        for d in (doc, doc2):
            for key in [k for k in d if "time" in k or "wall" in k
                        or k in ("started", "finished", "timestamp")]:
                d.pop(key)
        docs.append((doc, doc2))
    assert docs[0] == docs[1]
    assert docs[0][0]["files"][0]["rows"] > 5
    assert docs[0][0]["failures"][0]["file"] == "b.cihx"


def test_port_logger_namespacing_and_kv():
    from hsip_tpu_torch.utils.logging import _KVFormatter, kv

    log = port_utils.get_logger("test")
    assert log.name == "hsip_tpu_torch.test"
    assert port_utils.get_logger("hsip_tpu_torch.x").name == "hsip_tpu_torch.x"
    port_utils.set_log_level("DEBUG")
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Capture()
    root = logging.getLogger("hsip_tpu_torch")
    root.addHandler(handler)
    try:
        kv(log, logging.INFO, "hello", frames=10, fps=100)
    finally:
        root.removeHandler(handler)
        port_utils.set_log_level("INFO")
    assert any("hello" in r.getMessage() for r in records)
    line = _KVFormatter().format(records[-1])
    assert "frames=10" in line and "fps=100" in line
    # The JAX package's logger tree is untouched by the port's.
    assert not logging.getLogger("hsip_tpu").handlers or (
        logging.getLogger("hsip_tpu") is not root)
