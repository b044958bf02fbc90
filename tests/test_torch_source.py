"""The port's source runners against the JAX package's, on one directory.

``hsip_tpu_torch.pipeline.process_video_source`` and
``process_video_source_library`` run here on the CPU (``device="cpu"``) over
a mixed-shape library written by the port's own writer, and must leave what
``hsip_tpu.pipeline``'s runners leave: the same table files with the same
bytes, the same ``run-summary.json`` apart from wall times and the
backend's name, the same checkpoint behaviour (resume, retried failures,
the serve-mode failure cache). Tolerance: none.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import hsip_tpu.pipeline as jax_pipeline  # noqa: E402
from hsip_tpu.track import FileCalibration as JaxFileCalibration  # noqa: E402
from hsip_tpu.track import VideoSourceConfig as JaxSourceConfig  # noqa: E402

import hsip_tpu_torch.pipeline as port_pipeline  # noqa: E402
import hsip_tpu_torch.track.batch as port_batch  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.kernels._build import KernelError  # noqa: E402
from hsip_tpu_torch.track.config import FileCalibration, VideoSourceConfig  # noqa: E402
from hsip_tpu_torch.utils.profiling import StageTimes  # noqa: E402

from test_torch_library import pin_reference_puts  # noqa: E402


@pytest.fixture(autouse=True)
def _reference_puts_copy(monkeypatch):
    """The JAX package's library runs here put private copies
    (``test_torch_library.pin_reference_puts``)."""
    pin_reference_puts(monkeypatch)


_LIBRARY = (
    ("nova-run-1-001", (48, 512),
     FlameSpec(x0=30.0, v0_px=8.0, ignition_frame=2, seed=3)),
    ("nova-run-1-002", (48, 512),
     FlameSpec(x0=22.0, v0_px=5.0, ddt_frame=25, v_jump_px=24.0,
               ignition_frame=3, seed=5)),
    ("mini-run-2-001", (64, 384),
     FlameSpec(x0=28.0, v0_px=7.0, ignition_frame=4, seed=8)),
)


@pytest.fixture()
def library_dir(tmp_path):
    """Mixed-shape multi-recording library (two shape groups + one DDT)."""
    d = tmp_path / "library"
    for stem, (h, w), flame in _LIBRARY:
        frames, _ = synthesize_flame_video(48, height=h, width=w, flame=flame)
        write_recording(d, stem, frames,
                        spec=CihxSpec(width=w, height=h, total_frames=48,
                                      record_rate=100_000, bit_depth=12))
    return d


def _source(library_dir, out, jax=False, **kw):
    cls, cal = ((JaxSourceConfig, JaxFileCalibration) if jax
                else (VideoSourceConfig, FileCalibration))
    kw.setdefault("save_frame_images", False)
    kw.setdefault("save_stacked_sequences", False)
    cfg = cls(name="Lib", enabled=True, **kw)
    cfg.video_path = str(library_dir)
    cfg.output_dir = str(out)
    cfg.file_calibrations = [
        cal(calibration=0.000833333, position_offset=1.0159, files=["nova-"]),
        cal(calibration=0.000869565, position_offset=0.050237, files=["mini-"]),
    ]
    return cfg


def _tables(out):
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.txt"))}


# What legitimately differs between two runs: wall times (and the rate
# derived from them), the output directory, and the backend's name.
_RUN_SPECIFIC = {"wall_s", "total_wall_s", "frames_per_s", "phase_timings",
                 "_output_dir", "backend"}


def _summary(out):
    """run-summary.json without the run-specific keys."""
    def scrub(x):
        if isinstance(x, dict):
            return {k: scrub(v) for k, v in x.items() if k not in _RUN_SPECIFIC}
        if isinstance(x, list):
            return [scrub(v) for v in x]
        return x

    return scrub(json.loads((out / "run-summary.json").read_text()))


def test_library_runner_matches_jax_runner_and_per_file_device(library_dir, tmp_path):
    out_port, out_jax, out_dev = (tmp_path / n for n in ("port", "jax", "dev"))
    outs = port_pipeline.process_video_source_library(
        _source(library_dir, out_port), verbose=False, device="cpu")
    assert len(outs) == 3
    assert port_batch.LAST_GROUP_PATHS == ["fused", "fused"]
    jax_pipeline.process_video_source_library(
        _source(library_dir, out_jax, jax=True), verbose=False)
    port_pipeline.process_video_source(
        _source(library_dir, out_dev), backend="device", verbose=False,
        device="cpu")
    tables = _tables(out_port)
    assert tables and any("post-DDT" in n for n in tables)
    assert tables == _tables(out_jax)
    assert tables == _tables(out_dev)
    assert _summary(out_port) == _summary(out_jax)
    summary = json.loads((out_port / "run-summary.json").read_text())
    assert len(summary["files"]) == 3
    assert summary["config"]["backend"] == "library"


@pytest.mark.parametrize("port_backend,jax_backend", [("gpu", "tpu"),
                                                      ("device", "device"),
                                                      ("exact", "exact")])
def test_per_file_runner_matches_jax_runner(library_dir, tmp_path, port_backend,
                                            jax_backend):
    out_port, out_jax = tmp_path / "port", tmp_path / "jax"
    outs = port_pipeline.process_video_source(
        _source(library_dir, out_port), backend=port_backend, verbose=False,
        device="cpu")
    ref = jax_pipeline.process_video_source(
        _source(library_dir, out_jax, jax=True), backend=jax_backend,
        verbose=False)
    assert len(outs) == len(ref) == 3
    assert _tables(out_port) and _tables(out_port) == _tables(out_jax)
    assert _summary(out_port) == _summary(out_jax)


@pytest.mark.parametrize("runner", ["library", "gpu", "device", "exact"])
def test_corrupt_recording_warns_and_is_skipped(library_dir, tmp_path, capsys, runner):
    """One unreadable recording is warned about, listed under ``failures``
    and passed over, on every route; the others' tables and the summary
    equal the JAX runner's on the same directory. ``exact`` runs on no
    device (``device=None`` is the CPU there), the case that once lost the
    whole batch."""
    (library_dir / "broken.cihx").write_bytes(b"\x00 not a header" * 32)
    out, out_jax = tmp_path / "out", tmp_path / "jax"
    cfg, jcfg = _source(library_dir, out), _source(library_dir, out_jax, jax=True)
    if runner == "library":
        outs = port_pipeline.process_video_source_library(cfg, verbose=False,
                                                          device="cpu")
        assert capsys.readouterr().out.count("Could not load") == 1
        jax_pipeline.process_video_source_library(jcfg, verbose=False)
    else:
        outs = port_pipeline.process_video_source(
            cfg, backend=runner, verbose=False,
            device=None if runner == "exact" else "cpu")
        assert capsys.readouterr().out.count("Could not process") == 1
        jax_pipeline.process_video_source(
            jcfg, backend={"gpu": "tpu"}.get(runner, runner), verbose=False)
    assert len(outs) == 3  # the three good recordings still tracked
    summary = json.loads((out / "run-summary.json").read_text())
    assert [f["file"] for f in summary["failures"]] == ["broken.cihx"]
    assert len(summary["files"]) == 3
    assert _tables(out) and _tables(out) == _tables(out_jax)
    assert _summary(out) == _summary(out_jax)


@pytest.mark.parametrize("runner", ["library", "per_file"])
def test_resume_skips_done_and_retries_failed(library_dir, tmp_path, capsys, runner):
    def run(**kw):
        cfg = _source(library_dir, tmp_path / "out")
        if runner == "library":
            return port_pipeline.process_video_source_library(
                cfg, device="cpu", **kw)
        return port_pipeline.process_video_source(
            cfg, backend="device", device="cpu", **kw)

    good = (library_dir / "nova-run-1-002.cihx").read_bytes()
    (library_dir / "nova-run-1-002.cihx").write_bytes(b"\x00 not a header" * 32)
    assert len(run(verbose=False)) == 2
    out = tmp_path / "out"
    first = json.loads((out / "run-summary.json").read_text())
    assert [f["file"] for f in first["failures"]] == ["nova-run-1-002.cihx"]
    tables_before = _tables(out)
    capsys.readouterr()

    # Nothing repaired: the two done are skipped, the failed one retried.
    assert run(verbose=True, resume=True) == []
    text = capsys.readouterr().out
    assert text.count("already complete") == 2
    assert "nova-run-1-002" in text and "Could not" in text

    # Repaired: the resume run processes it alone and the summary is whole.
    (library_dir / "nova-run-1-002.cihx").write_bytes(good)
    outs = run(verbose=False, resume=True)
    assert len(outs) == 1 and outs[0].rows
    summary = json.loads((out / "run-summary.json").read_text())
    assert len(summary["files"]) == 3 and not summary["failures"]
    after = _tables(out)
    assert set(after) > set(tables_before)
    assert all(after[k] == v for k, v in tables_before.items())

    # Everything done: a further resume processes nothing and leaves the
    # tables and the summary as they were.
    summary_bytes = (out / "run-summary.json").read_bytes()
    assert run(verbose=False, resume=True) == []
    assert _tables(out) == after
    assert (out / "run-summary.json").read_bytes() == summary_bytes


@pytest.mark.parametrize("runner", ["library", "per_file"])
def test_failure_cache_skips_unchanged_failures(library_dir, tmp_path, capsys, runner):
    broken = library_dir / "broken.cihx"
    broken.write_bytes(b"\x00 not a header" * 32)
    cache = {}

    def run():
        cfg = _source(library_dir, tmp_path / "out")
        if runner == "library":
            return port_pipeline.process_video_source_library(
                cfg, verbose=False, resume=True, failure_cache=cache,
                device="cpu")
        return port_pipeline.process_video_source(
            cfg, backend="device", verbose=False, resume=True,
            failure_cache=cache, device="cpu")

    assert len(run()) == 3
    assert "Could not" in capsys.readouterr().out
    assert list(cache) == [str(broken)]
    assert port_pipeline._skip_known_failure(cache, broken)
    # Unchanged: not retried, no second warning.
    assert run() == []
    assert "Could not" not in capsys.readouterr().out
    # Changed (size differs): retried, and it fails again.
    broken.write_bytes(b"\x00 still not a header" * 40)
    assert not port_pipeline._skip_known_failure(cache, broken)
    assert run() == []
    assert "Could not" in capsys.readouterr().out
    # The helpers agree with the originals on the same cache.
    assert (port_pipeline._skip_known_failure(cache, broken)
            == jax_pipeline._skip_known_failure(cache, broken))
    assert port_pipeline._file_fingerprint(broken) == jax_pipeline._file_fingerprint(broken)
    broken.unlink()
    assert port_pipeline._skip_known_failure(cache, broken)  # vanished
    assert not port_pipeline._skip_known_failure(None, broken)


def test_empty_directory_returns_nothing(tmp_path):
    empty = tmp_path / "none"
    empty.mkdir()
    cfg = _source(empty, tmp_path / "out")
    assert port_pipeline.process_video_source_library(cfg, verbose=False,
                                                      device="cpu") == []
    assert port_pipeline.process_video_source(cfg, backend="device",
                                              verbose=False, device="cpu") == []
    assert not (tmp_path / "out").exists()
    cfg.video_path = None
    assert port_pipeline.process_video_source_library(cfg, verbose=False,
                                                      device="cpu") == []


def test_unmatched_calibration_warns_per_recording(library_dir, tmp_path, capsys):
    cfg = _source(library_dir, tmp_path / "out")
    cfg.file_calibrations = [FileCalibration(calibration=0.5, position_offset=0.0,
                                             files=["9000:9999"])]
    port_pipeline.process_video_source_library(cfg, verbose=False, device="cpu")
    assert capsys.readouterr().out.count("no file_calibration entry matches") == 3


def test_library_survives_one_table_write_failure(library_dir, tmp_path, capsys,
                                                  monkeypatch):
    real_writer = port_pipeline._write_ddt_split_tables

    def flaky(output, output_dir, stem, verbose=True):
        if stem == "nova-run-1-001":
            raise OSError("disk quota exceeded")
        return real_writer(output, output_dir, stem, verbose)

    monkeypatch.setattr(port_pipeline, "_write_ddt_split_tables", flaky)
    out = tmp_path / "out"
    outs = port_pipeline.process_video_source_library(
        _source(library_dir, out), verbose=False, device="cpu")
    assert len(outs) == 3
    assert "Could not write results for nova-run-1-001" in capsys.readouterr().out
    assert (out / "mini-run-2-001-flame-position.txt").exists()
    assert not (out / "nova-run-1-001-flame-position.txt").exists()
    summary = json.loads((out / "run-summary.json").read_text())
    assert [f["file"] for f in summary["failures"]] == ["nova-run-1-001.cihx"]


def test_resume_keys_on_the_relative_path(tmp_path):
    """Two recordings that share a basename in different subdirectories are
    two entries of the ledger."""
    src, out = tmp_path / "videos", tmp_path / "out"
    spec = CihxSpec(width=256, height=32, total_frames=24, record_rate=50_000,
                    bit_depth=12)

    def write(sub, seed, x0, v0):
        frames, _ = synthesize_flame_video(
            24, height=32, width=256,
            flame=FlameSpec(x0=x0, v0_px=v0, ignition_frame=2, seed=seed))
        write_recording(src / sub, "dup-run-1-001", frames, spec=spec)

    write("shot-A", 31, 20.0, 4.0)
    cfg = VideoSourceConfig(name="dup", enabled=True, calibration=0.0008,
                            save_frame_images=False, save_stacked_sequences=False)
    cfg.video_path, cfg.output_dir = str(src), str(out)
    port_pipeline.process_video_source_library(cfg, verbose=False, device="cpu")
    first = (out / "dup-run-1-001-flame-position.txt").read_bytes()
    write("shot-B", 37, 40.0, 7.0)
    outs = port_pipeline.process_video_source_library(cfg, verbose=False,
                                                      resume=True, device="cpu")
    assert len(outs) == 1
    assert (out / "dup-run-1-001-flame-position.txt").read_bytes() != first


class _Processor:
    """The duck-typed processor of a two-process run, seen from one rank."""

    def __init__(self, rank):
        self.rank, self.is_root, self.barriers = rank, rank == 0, 0

    def distribute_indices(self, n):
        return list(range(self.rank, n, 2))

    def barrier(self):
        self.barriers += 1


@pytest.mark.parametrize("runner", ["library", "per_file"])
def test_processor_splits_files_and_writes_rank_ledgers(library_dir, tmp_path, runner):
    out = tmp_path / "out"
    counts = []
    for rank in (0, 1):
        proc = _Processor(rank)
        cfg = _source(library_dir, out)
        stages = StageTimes()
        if runner == "library":
            outs = port_pipeline.process_video_source_library(
                cfg, processor=proc, verbose=False, resume=rank == 1,
                device="cpu", stage_times=stages)
        else:
            outs = port_pipeline.process_video_source(
                cfg, backend="device", processor=proc, verbose=False,
                resume=rank == 1, device="cpu", stage_times=stages)
        counts.append(len(outs))
        assert proc.barriers == 2  # after ledger set-up, and in finish()
        # Both barriers are timed as rank_wait; discovery counts the split.
        seen = stages.as_dict(ndigits=9)
        assert "rank_wait" in seen
        assert seen["count.rank_recordings"] == [2, 1][rank]
    assert counts == [2, 1]
    assert (out / "hsip-checkpoint.json").exists()
    assert (out / "hsip-checkpoint.rank1.json").exists()
    assert len(_tables(out)) >= 3


def test_library_figures_are_those_of_per_file_mode(tmp_path):
    """The figure replay writes the same figure files as per-file mode."""
    d = tmp_path / "fig"
    for i, seed in enumerate((11, 13)):
        frames, _ = synthesize_flame_video(
            10, height=32, width=192,
            flame=FlameSpec(x0=20, v0_px=8, ignition_frame=2, seed=seed))
        write_recording(d, f"figlib-run-{i + 1}-001", frames,
                        spec=CihxSpec(width=192, height=32, total_frames=10,
                                      record_rate=50_000))

    def source(out):
        cfg = VideoSourceConfig(name="FigLib", enabled=True,
                                figure_style="compact", save_frame_images=True,
                                save_stacked_sequences=True)
        cfg.video_path, cfg.output_dir = str(d), str(out)
        return cfg

    out_lib, out_pf = tmp_path / "lib", tmp_path / "pf"
    outs = port_pipeline.process_video_source_library(source(out_lib),
                                                      verbose=False, device="cpu")
    assert len(outs) == 2
    port_pipeline.process_video_source(source(out_pf), backend="gpu",
                                       verbose=False, device="cpu")
    lib = sorted(str(p.relative_to(out_lib)) for p in out_lib.rglob("*.png"))
    pf = sorted(str(p.relative_to(out_pf)) for p in out_pf.rglob("*.png"))
    assert lib and lib == pf
    assert any("stacked-sequence" in n for n in lib)
    assert any("Frame" in n for n in lib)
    assert _tables(out_lib) and _tables(out_lib) == _tables(out_pf)


@pytest.mark.parametrize("runner", ["library", "per_file"])
def test_default_device_needs_cuda(library_dir, tmp_path, monkeypatch, runner):
    """No device named: the runners raise without a card, before any file
    is opened and before the warn-and-skip guard could swallow it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _source(library_dir, tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if runner == "library":
            port_pipeline.process_video_source_library(cfg, verbose=False)
        else:
            port_pipeline.process_video_source(cfg, verbose=False)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("runner", ["library", "per_file", "figures"])
def test_kernel_errors_are_raised_not_skipped(library_dir, tmp_path, monkeypatch,
                                              runner):
    """A recording that fails is warned about and skipped; a kernel that
    does not build or launch is not."""
    def broken(*args, **kwargs):
        raise KernelError("nvcc failed")

    cfg = _source(library_dir, tmp_path / "out",
                  save_frame_images=runner == "figures", figure_style="compact")
    with pytest.raises(KernelError):
        if runner == "library":
            monkeypatch.setattr(port_batch, "_track_uniform_videos", broken)
            port_pipeline.process_video_source_library(cfg, verbose=False,
                                                       device="cpu")
        elif runner == "per_file":
            monkeypatch.setattr(port_pipeline, "track_video", broken)
            port_pipeline.process_video_source(cfg, backend="device",
                                               verbose=False, device="cpu")
        else:
            monkeypatch.setattr(port_pipeline, "track_video", broken)
            port_pipeline.process_video_source_library(cfg, verbose=False,
                                                       device="cpu")
    assert issubclass(KernelError, RuntimeError)


@pytest.mark.parametrize("runner", ["per_file", "figures"])
@pytest.mark.parametrize("error", ["late_cuda_error", "out_of_memory", "recording"])
def test_late_cuda_errors_are_raised_not_skipped(library_dir, tmp_path, monkeypatch,
                                                 runner, error):
    """A kernel's fault can surface after its launch, as torch's own
    RuntimeError at the next synchronisation. On a CUDA device the runners
    raise it (every later recording would fail the same way); a
    recording's own error is still warned about and skipped."""
    exc = {"late_cuda_error": RuntimeError(
               "CUDA error: an illegal memory access was encountered"),
           "out_of_memory": torch.cuda.OutOfMemoryError("CUDA out of memory."),
           "recording": ValueError("truncated payload")}[error]

    def broken(*args, **kwargs):
        raise exc

    cuda = torch.device("cuda")
    monkeypatch.setattr(port_pipeline, "resolve_device", lambda device: cuda)
    monkeypatch.setattr(port_pipeline, "process_video_file", broken)
    cfg = _source(library_dir, tmp_path / "out",
                  save_frame_images=runner == "figures", figure_style="compact")

    def run():
        if runner == "per_file":
            return port_pipeline.process_video_source(cfg, backend="device",
                                                      verbose=False)
        # The batched scan itself on the CPU; the figure replay sees `cuda`.
        real = port_batch.track_collection_device
        monkeypatch.setattr(
            port_batch, "track_collection_device",
            lambda *a, **kw: real(*a, **{**kw, "device": "cpu"}))
        return port_pipeline.process_video_source_library(cfg, verbose=False)

    if error == "recording":
        outs = run()
        assert len(outs) == (0 if runner == "per_file" else 3)
    else:
        with pytest.raises(type(exc)):
            run()
    # On a CPU device the same text is a recording's error like any other.
    assert not port_pipeline._is_device_failure(
        RuntimeError("CUDA error: x"), torch.device("cpu"))
    assert port_pipeline._is_device_failure(KernelError("x"), torch.device("cpu"))


def test_unknown_backend_is_refused(library_dir, tmp_path):
    with pytest.raises(ValueError, match="Unknown backend"):
        port_pipeline.process_video_source(
            _source(library_dir, tmp_path / "out"), backend="tpu",
            verbose=False, device="cpu")
