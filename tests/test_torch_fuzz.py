"""The randomized sweeps of tests/test_fuzz.py, run on the port against the JAX package.

Each sweep draws its cases with the JAX file's own recipe and seeds
(written out once, without JAX, in ``chip_smoke.py``, whose phase 11 runs
the same sweeps on the card; ``test_recipe_is_the_jax_files_draw`` holds
every draw used here and there to the JAX file's). One dict builds both
packages' configs, and one recording, written by ``hsip_tpu.io``, is read
by both. Always on: every case is a case of a parametrized test.

- the whole pipeline: the port's 'gpu', 'device' and 'exact' on the CPU
  against ``hsip_tpu``'s 'tpu', 'device' and 'exact' (rows, break reason,
  empty frames, tables byte for byte), with the port's staging route of
  each case; the seeds cover 'band+counts', 'packed' and 'host_exact';
- library mode: the port's ``process_video_source_library`` against
  ``hsip_tpu``'s per-file 'device' run, tables byte for byte;
- the scan: ``tracking_scan_plain`` against ``device_tracking_scan`` on
  the random configs and on the four adversarial value classes, all nine
  fields equal (the JAX file holds the Pallas kernel to the latter).
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hsip_tpu import io as jax_io  # noqa: E402
from hsip_tpu import pipeline as jax_pipeline  # noqa: E402
from hsip_tpu.track import FlameDetectorConfig as JaxDetector  # noqa: E402
from hsip_tpu.track import VideoSourceConfig as JaxSource  # noqa: E402
from hsip_tpu.track.device_scan import device_tracking_scan  # noqa: E402
from hsip_tpu.track.scan import MIN_SIGNAL_FRACTION, compute_profiles_batched  # noqa: E402
from hsip_tpu_torch import pipeline as port_pipeline  # noqa: E402
from hsip_tpu_torch.track import batch as port_batch  # noqa: E402
from hsip_tpu_torch.track.config import FlameDetectorConfig as PortDetector  # noqa: E402
from hsip_tpu_torch.track.config import VideoSourceConfig as PortSource  # noqa: E402
from hsip_tpu_torch.track.device_scan import tracking_scan_plain  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load("chip_smoke_recipes", REPO / "chip_smoke.py")

# The first ten seeds: seed 1 is the first 'packed' case (12 bits, W=255)
# and seed 9 the first 'host_exact' one (k=4 over a folding band, H=16).
PIPELINE_SEEDS = range(10)
LIBRARY_SEEDS = range(3)
ROUTES = {"band+counts", "packed", "host_exact"}
BACKENDS = (("gpu", "tpu"), ("device", "device"), ("exact", "exact"))


@pytest.fixture(autouse=True)
def _one_thread():
    """Small runs: one intra-op thread keeps them off the other workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _source(case, cls, out_dir):
    cfg = cls(save_frame_images=False, save_stacked_sequences=False, **case["source"])
    cfg.output_dir = str(out_dir)
    return cfg


def _tables(out_dir):
    return {p.name: p.read_bytes() for p in sorted(Path(out_dir).glob("*.txt"))}


def _port_route(case, meta):
    out = port_pipeline.process_video_file(
        meta, _source(case, PortSource, "unused"), PortDetector(**case["detector"]),
        backend="gpu", verbose=False, write_outputs=False, device="cpu")
    return out.phase_timings["staging_route"]


@pytest.mark.parametrize("seed", PIPELINE_SEEDS)
def test_random_config_parity(seed, tmp_path):
    """The port's three backends against the JAX package's on one random
    config: rows, break reason and empty-frame count equal, tables byte
    for byte; the port's own backends agree on the positions (the JAX
    file's check)."""
    case = smoke.fuzz_pipeline_case(seed)
    meta = smoke.write_fuzz_recording(case, tmp_path / "rec", jax_io)
    outs, tables = {}, {}
    for port_backend, jax_backend in BACKENDS:
        for key, run, det, src, extra in (
                (("port", port_backend), port_pipeline.process_video_file, PortDetector,
                 PortSource, dict(backend=port_backend, device="cpu")),
                (("jax", jax_backend), jax_pipeline.process_video_file, JaxDetector,
                 JaxSource, dict(backend=jax_backend))):
            out_dir = tmp_path / "-".join(key)
            outs[key] = run(meta, _source(case, src, out_dir), det(**case["detector"]),
                            verbose=False, **extra)
            tables[key] = _tables(out_dir)
    route = outs["port", "gpu"].phase_timings["staging_route"]
    assert route in ROUTES
    assert outs["port", "device"].phase_timings["staging_route"] == route
    label = (f"seed {seed} ({route}, H={case['height']} W={case['width']} "
             f"depth={case['depth']} k={case['detector']['morphology_kernel_size']})")
    for port_backend, jax_backend in BACKENDS:
        got, want = outs["port", port_backend], outs["jax", jax_backend]
        assert got.rows == want.rows, f"{label}: {port_backend} rows"
        assert got.break_reason == want.break_reason, f"{label}: {port_backend}"
        assert got.empty_frame_count == want.empty_frame_count, f"{label}: {port_backend}"
        assert tables["port", port_backend] == tables["jax", jax_backend], label
        exact = outs["port", "exact"]
        assert (got.rows, got.break_reason, got.empty_frame_count) == (
            exact.rows, exact.break_reason, exact.empty_frame_count), label


def test_pipeline_seeds_cover_every_route(tmp_path):
    """The parity sweep's seeds take all three staging routes of the
    port's map phase, and every bit depth."""
    routes, depths = set(), set()
    for seed in PIPELINE_SEEDS:
        case = smoke.fuzz_pipeline_case(seed)
        routes.add(_port_route(case, smoke.write_fuzz_recording(
            case, tmp_path / str(seed), jax_io)))
        depths.add(case["depth"])
    assert routes == ROUTES
    assert depths == {8, 10, 12, 16}


@pytest.mark.parametrize("seed", LIBRARY_SEEDS)
def test_random_library_matches_jax(seed, tmp_path):
    """The port's library mode (mixed shapes, lengths and 12/16-bit depths
    in one source) writes the JAX package's per-file 'device' tables."""
    videos = smoke.fuzz_library_case(seed)
    lib = tmp_path / "lib"
    smoke.write_fuzz_library(videos, lib, jax_io)

    def cfg(cls, out):
        c = cls(name="FL", save_frame_images=False, save_stacked_sequences=False,
                calibration=0.000833333, position_offset=1.0)
        c.video_path = str(lib)
        c.output_dir = str(tmp_path / out)
        return c

    outs = port_pipeline.process_video_source_library(cfg(PortSource, "port"),
                                                      verbose=False, device="cpu")
    # The group paths chip_smoke.py's library sweep expects on the card.
    assert port_batch.LAST_GROUP_PATHS == smoke.library_groups(videos)[0]
    jax_pipeline.process_video_source(cfg(JaxSource, "jax"), backend="device",
                                      verbose=False)
    assert len(outs) == len(videos)
    port_tables, jax_tables = _tables(tmp_path / "port"), _tables(tmp_path / "jax")
    assert port_tables and port_tables == jax_tables, f"seed {seed}"


def _assert_scans_equal(args, kw, intens, label):
    """``tracking_scan_plain`` on one video against ``device_tracking_scan``."""
    fidx, sob, grad, empty, prior = args

    def t(x):
        return None if x is None else torch.from_numpy(np.asarray(x))[None]

    want = device_tracking_scan(
        fidx, sob, grad, jnp.asarray(empty), jnp.asarray(prior), **kw,
        **({} if intens is None else dict(intensity_lines=jnp.asarray(intens))))
    got = tracking_scan_plain(t(fidx), t(sob), t(grad), t(empty), t(prior),
                              intensity_lines=t(intens), **kw)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(getattr(got, name)[0].numpy().astype(w.dtype), w,
                                      err_msg=f"{label} {name}")


@pytest.mark.parametrize("method", smoke.FUZZ_METHODS)
@pytest.mark.parametrize("seed", [0])
def test_random_scan_parity(seed, method):
    """A random config's profiles (the JAX map phase) through both scans."""
    case = smoke.fuzz_scan_case(seed, method)
    det = JaxDetector(**case["detector"])
    frames, _ = jax_io.synthesize_flame_video(case["n"], height=case["height"],
                                              width=case["width"],
                                              flame=jax_io.FlameSpec(**case["flame"]))
    p = compute_profiles_batched(lambda a, b: frames[a:b], case["n"],
                                 (case["height"], case["width"]), float(frames[0].max()),
                                 det, chunk_size=16)
    empty = p.signal_counts / p.total_pixels < MIN_SIGNAL_FRACTION
    intens, has_prior = None, p.has_prior
    if method != "combined":
        intens, has_prior = p.select_intensity(method, True)
    args = (np.asarray(p.frame_indices, np.int32), np.asarray(p.sobel_lines),
            np.asarray(p.gradient_lines), empty, has_prior)
    _assert_scans_equal(args, smoke.fuzz_scan_params(case, det), intens,
                        f"seed {seed} {method} W={case['width']}")


@pytest.mark.parametrize("method", smoke.FUZZ_METHODS)
def test_adversarial_scan_soak(method):
    """Noise, heavy ties, sparse spikes and a flat plateau, edge margin 0,
    scattered frame indices, frame rate 0 drawn: both scans agree."""
    for kind, fidx, sob, grad, prof, empty, prior, kw in smoke.adversarial_scan_cases(method):
        _assert_scans_equal((fidx, sob, grad, empty, prior), kw,
                            None if method == "combined" else prof,
                            f"{method} kind={kind} frame_rate={kw['frame_rate']}")


# ---- the recipe: chip_smoke.py's draws are tests/test_fuzz.py's ----

class _Captured(Exception):
    """Raised by a stand-in to stop the JAX test once it has drawn."""


@functools.lru_cache(maxsize=None)
def _jax_fuzz_module():
    return _load("jax_fuzz_draws", REPO / "tests" / "test_fuzz.py")


def _files(directory):
    return {p.name: p.read_bytes() for p in sorted(Path(directory).iterdir())}


def _same_config(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("seed", range(24))
def test_recipe_is_the_jax_files_draw_pipeline(seed, tmp_path, monkeypatch):
    """The JAX file's pipeline test, stopped at its first run: its
    recording, detector and source config are the recipe's."""
    seen = {}

    def stand_in(meta, cfg, det, **_kw):
        seen.update(files=_files(Path(meta).parent), cfg=cfg, det=det)
        raise _Captured

    module = _jax_fuzz_module()
    monkeypatch.setattr(module, "process_video_file", stand_in)
    with pytest.raises(_Captured):
        module.test_random_config_backend_parity(seed)
    case = smoke.fuzz_pipeline_case(seed)
    smoke.write_fuzz_recording(case, tmp_path, jax_io)
    assert seen["files"] == _files(tmp_path)
    _same_config(seen["det"], JaxDetector(**case["detector"]))
    _same_config(seen["cfg"], JaxSource(save_frame_images=False,
                                        save_stacked_sequences=False, **case["source"]))


@pytest.mark.parametrize("seed", LIBRARY_SEEDS)
def test_recipe_is_the_jax_files_draw_library(seed, tmp_path, monkeypatch):
    seen = {}

    def stand_in(cfg, **_kw):
        seen["files"] = _files(cfg.video_path)
        raise _Captured

    monkeypatch.setattr(jax_pipeline, "process_video_source_library", stand_in)
    (tmp_path / "jax").mkdir()
    with pytest.raises(_Captured):
        _jax_fuzz_module().test_random_library_matches_per_file(seed, tmp_path / "jax")
    smoke.write_fuzz_library(smoke.fuzz_library_case(seed), tmp_path / "recipe", jax_io)
    assert seen["files"] == _files(tmp_path / "recipe")


@pytest.mark.parametrize("method", smoke.FUZZ_METHODS)
@pytest.mark.parametrize("seed", [0, 1])
def test_recipe_is_the_jax_files_draw_scan(seed, method, monkeypatch):
    """The JAX scan test's frames, detector config and scan arguments."""
    from hsip_tpu.track import device_scan, scan

    seen = {}

    def profiles(read, n, shape, bg, det, **kw):
        seen.update(frames=read(0, n), shape=shape, det=det, kw=kw)
        return compute_profiles_batched(read, n, shape, bg, det, **kw)

    def stand_in(*args, **kw):
        seen["scan"] = kw
        raise _Captured

    monkeypatch.setattr(scan, "compute_profiles_batched", profiles)
    monkeypatch.setattr(device_scan, "device_tracking_scan", stand_in)
    with pytest.raises(_Captured):
        _jax_fuzz_module().test_random_pallas_scan_parity(seed, method)
    case = smoke.fuzz_scan_case(seed, method)
    frames, _ = jax_io.synthesize_flame_video(case["n"], height=case["height"],
                                              width=case["width"],
                                              flame=jax_io.FlameSpec(**case["flame"]))
    np.testing.assert_array_equal(seen["frames"], frames)
    assert seen["shape"] == (case["height"], case["width"]) and seen["kw"] == {"chunk_size": 16}
    det = JaxDetector(**case["detector"])
    _same_config(seen["det"], det)
    seen["scan"].pop("intensity_lines", None)
    assert seen["scan"] == smoke.fuzz_scan_params(case, det)


@pytest.mark.parametrize("method", smoke.FUZZ_METHODS)
def test_recipe_is_the_jax_files_draw_adversarial(method, monkeypatch):
    """The JAX soak's four value classes, argument for argument."""
    from hsip_tpu.track import device_scan, pallas_scan

    class NoFields:
        _fields = ()

    calls = []

    def stand_in(*args, **kw):
        calls.append(([np.asarray(a) for a in args], kw))
        return NoFields()

    monkeypatch.setattr(device_scan, "device_tracking_scan", stand_in)
    monkeypatch.setattr(pallas_scan, "pallas_tracking_scan", lambda *a, **kw: NoFields())
    _jax_fuzz_module().test_adversarial_pallas_scan_soak(method)
    cases = smoke.adversarial_scan_cases(method)
    assert len(calls) == len(cases) == 4
    for (args, kw), (kind, fidx, sob, grad, prof, empty, prior, want_kw) in zip(calls, cases):
        for got, want in zip(args, (fidx, sob, grad, empty, prior)):
            np.testing.assert_array_equal(got, want, err_msg=f"kind {kind}")
        intens = kw.pop("intensity_lines", None)
        if method != "combined":
            np.testing.assert_array_equal(np.asarray(intens), prof)
        assert kw == want_kw, f"kind {kind}"
