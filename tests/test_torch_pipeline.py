"""The port's per-file pipeline against the golden table and the JAX package.

``hsip_tpu_torch.pipeline.process_video_file`` runs here on the CPU
(``device="cpu"``: the plain PyTorch versions of both kernels) and must
write tables byte-identical to ``tests/golden/`` and to
``hsip_tpu.pipeline.process_video_file`` ('tpu' against 'gpu', 'device'
against 'device').
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from hsip_tpu import pipeline as jax_pipeline  # noqa: E402
from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording  # noqa: E402
from hsip_tpu.track import FileCalibration, FlameDetectorConfig, VideoSourceConfig  # noqa: E402
from hsip_tpu_torch import pipeline as port_pipeline  # noqa: E402
from hsip_tpu_torch.kernels import _build  # noqa: E402
from hsip_tpu_torch.kernels.cuda_preprocess import cuda_band_profiles  # noqa: E402
from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "golden-run-1-001-flame-position.txt"


def _golden_recording(tmp_path):
    """The recording of tests/test_golden.py."""
    flame = FlameSpec(x0=30.0, v0_px=8.0, accel_px=0.3, ignition_frame=3,
                      ddt_frame=28, v_jump_px=25.0, seed=77)
    frames, _ = synthesize_flame_video(60, height=48, width=512, flame=flame)
    spec = CihxSpec(width=512, height=48, total_frames=60, record_rate=100_000,
                    bit_depth=12, start_frame=-10)
    meta = write_recording(tmp_path, "golden-run-1-001", frames, spec=spec)
    cfg = VideoSourceConfig(name="G", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    cfg.file_calibrations = [
        FileCalibration(calibration=0.000833333, position_offset=1.0159,
                        files=["run-1-"]),
    ]
    return meta, cfg


@pytest.mark.parametrize("backend", ["gpu", "device", "exact"])
def test_port_reproduces_golden_table(tmp_path, backend):
    meta, cfg = _golden_recording(tmp_path)
    port_pipeline.process_video_file(meta, cfg, backend=backend, verbose=False,
                                     device="cpu")
    produced = tmp_path / "out" / "golden-run-1-001-flame-position.txt"
    assert produced.read_bytes() == GOLDEN.read_bytes()


def _tables(out_dir):
    return {p.name: p.read_bytes() for p in sorted(Path(out_dir).glob("*.txt"))}


@pytest.mark.parametrize("method", ["combined", "threshold", "half_maximum",
                                    "gradient"])
@pytest.mark.parametrize("port_backend,jax_backend", [("gpu", "tpu"),
                                                      ("device", "device")])
def test_port_tables_match_jax_package(flame_recording, tmp_path, method,
                                       port_backend, jax_backend):
    """Byte-identical tables on the `flame_recording` fixture (frames before
    ignition are empty), with skip frames, for every detector."""
    def cfg(out):
        c = VideoSourceConfig(name="S", detection_method=method,
                              calibration=0.0008, position_offset=0.5,
                              skip_frames=[6, 7, 15],
                              save_frame_images=False,
                              save_stacked_sequences=False)
        c.output_dir = str(tmp_path / out)
        return c

    path = flame_recording["path"]
    ref = jax_pipeline.process_video_file(path, cfg("jax"), backend=jax_backend,
                                          verbose=False)
    got = port_pipeline.process_video_file(path, cfg("port"), backend=port_backend,
                                           verbose=False, device="cpu")
    assert ref.empty_frame_count > 0 and len(ref.rows) > 5
    assert got.empty_frame_count == ref.empty_frame_count
    assert got.break_reason == ref.break_reason
    jt, pt = _tables(tmp_path / "jax"), _tables(tmp_path / "port")
    assert jt and pt == jt


def test_even_kernel_folding_band_takes_exact_route(tmp_path):
    """An even morphology kernel over a band that folds (16-row frames)
    must take the float64 host ops, equal to the exact backend."""
    from hsip_tpu import open_video
    from hsip_tpu_torch.track.scan import compute_profiles_batched

    frames, _ = synthesize_flame_video(
        20, height=16, width=256,
        flame=FlameSpec(x0=30, v0_px=8, ignition_frame=2, seed=11))
    meta = write_recording(tmp_path, "ek-run-1", frames,
                           spec=CihxSpec(width=256, height=16, total_frames=20,
                                         record_rate=50_000))
    cfg = VideoSourceConfig(name="EK", save_frame_images=False,
                            save_stacked_sequences=False)
    det = FlameDetectorConfig(morphology_kernel_size=4)
    kw = dict(verbose=False, write_outputs=False)
    g = port_pipeline.process_video_file(meta, cfg, det, backend="gpu",
                                         device="cpu", **kw)
    d = port_pipeline.process_video_file(meta, cfg, det, backend="device",
                                         device="cpu", **kw)
    e = port_pipeline.process_video_file(meta, cfg, det, backend="exact", **kw)
    j = jax_pipeline.process_video_file(meta, cfg, det, backend="tpu", **kw)
    assert len(e.rows) > 5
    for out in (g, d, j):
        assert [r[:3] for r in out.rows] == [r[:3] for r in e.rows]
        assert out.break_reason == e.break_reason
    with open_video(str(meta)) as v:
        p = compute_profiles_batched(v.read_batch, len(v), v.frame_shape,
                                     float(v[0].max()), det, device="cpu")
    assert p.staging_route == "host_exact"


@pytest.mark.parametrize("backend", ["gpu", "device"])
def test_default_device_needs_cuda(flame_recording, monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VideoSourceConfig(name="S", save_frame_images=False,
                            save_stacked_sequences=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_pipeline.process_video_file(flame_recording["path"], cfg,
                                         backend=backend, verbose=False,
                                         write_outputs=False)


def test_cpu_run_launches_no_kernel_and_never_builds(flame_recording,
                                                     monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU run must not build the CUDA kernels")

    monkeypatch.setattr(_build, "build_kernels", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    monkeypatch.setattr(cuda_band_profiles, "launches", 0)
    monkeypatch.setattr(cuda_tracking_scan, "launches", 0)
    cfg = VideoSourceConfig(name="S", save_frame_images=False,
                            save_stacked_sequences=False)
    for backend in ("gpu", "device"):
        out = port_pipeline.process_video_file(
            flame_recording["path"], cfg, backend=backend, verbose=False,
            write_outputs=False, device="cpu")
        assert len(out.rows) > 5
    assert cuda_band_profiles.launches == 0
    assert cuda_tracking_scan.launches == 0


_GUARD = r"""
import sys


class _Block:
    # Makes jax and the JAX package unimportable (hsip_tpu_torch stays).
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "hsip_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _Block())
import hsip_tpu_torch
import os
from hsip_tpu_torch.pipeline import (process_video_file, process_video_source,
                                     process_video_source_library)
from hsip_tpu_torch.track import batch
from hsip_tpu_torch.track.config import FileCalibration, VideoSourceConfig

cfg = VideoSourceConfig(name="G", save_frame_images=False,
                        save_stacked_sequences=False)
cfg.file_calibrations = [FileCalibration(calibration=0.000833333,
                                         position_offset=1.0159,
                                         files=["run-1-"])]
for backend in ("gpu", "device", "exact"):
    cfg.output_dir = sys.argv[2] + "/" + backend
    out = process_video_file(sys.argv[1], cfg, backend=backend, verbose=False,
                             device="cpu")
    assert len(out.rows) > 5, backend
# Library mode (the fused group program, then the chunked path) and the
# per-file source runner over the recording's directory.
cfg.video_path = os.path.dirname(sys.argv[1])
for tag, fused in (("library", "1"), ("chunked", "0")):
    os.environ["HSIP_FUSED"] = fused
    cfg.output_dir = sys.argv[2] + "/" + tag
    outs = process_video_source_library(cfg, verbose=False, device="cpu")
    assert len(outs) == 1 and len(outs[0].rows) > 5, tag
    assert batch.LAST_GROUP_PATHS == ["fused" if fused == "1" else "chunked"]
cfg.output_dir = sys.argv[2] + "/source"
assert len(process_video_source(cfg, backend="device", verbose=False,
                                device="cpu")) == 1
# The command line, per file and in library mode, over the same directory.
from hsip_tpu_torch.cli import main

for tag, flags in (("cli", []), ("cli-library", ["--library"]),
                   ("cli-mesh", ["--library", "--mesh", "2"])):
    rc = main(["--video-path", cfg.video_path, "--output-dir",
               sys.argv[2] + "/" + tag, "--calibration", "0.000833333",
               "--position-offset", "1.0159", "--no-images", "--no-sequences",
               "--quiet", "--device", "cpu", *flags])
    assert rc == 0, (tag, rc)
# Both examples, as scripts.
import runpy

out_root = sys.argv[2]
for script, argv in (("demo_torch.py", ["--no-images", "--no-sequences", "--quiet"]),
                     ("library_torch.py", [])):
    sys.argv[:] = [script, out_root + "/" + script[:-3], "--device", "cpu", *argv]
    try:
        runpy.run_path(os.path.join("examples", script), run_name="__main__")
    except SystemExit as exit_:
        assert exit_.code == 0, (script, exit_.code)
# The benchmark and the two stage tools, as scripts, at a tiny size, on
# the fused library path (HSIP_FUSED=0 above chose the chunked one).
os.environ.pop("HSIP_FUSED")
tiny = ["--device", "cpu", "--frames", "16", "--height", "64", "--width", "256",
        "--videos", "2"]
for script, argv in (
        ("bench_torch.py", ["--repeat", "1", "--baseline-sample", "4", "--videos16", "0",
                            "--samples-out", out_root + "/bench-samples.json"]),
        ("tools/stage_profile_torch.py", ["--repeat", "1",
                                          "--cache-dir", out_root + "/stage-cache"]),
        ("tools/pipeline_trace_torch.py", ["--groups", "1", "2", "--repeats", "1"])):
    sys.argv[:] = [script, *tiny, *argv]
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as exit_:
        assert exit_.code == 0, (script, exit_.code)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "hsip_tpu"))
assert loaded == [], loaded
print("ok")
"""


def test_port_runs_without_jax(tmp_path):
    """With jax and hsip_tpu unimportable, the port's CPU run of every
    backend, of library mode (fused and chunked), of the per-file source
    runner and of the command line (per file, ``--library`` and ``--library
    --mesh 2`` on CPU slots) writes the
    golden table byte for byte, and both examples, bench_torch.py and the
    two stage tools run to their end."""
    meta, _ = _golden_recording(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, str(meta), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    for backend in ("gpu", "device", "exact", "library", "chunked", "source",
                    "cli", "cli-library", "cli-mesh"):
        produced = tmp_path / "out" / backend / GOLDEN.name
        assert produced.read_bytes() == GOLDEN.read_bytes(), backend
    bench = json.loads((tmp_path / "out" / "bench-samples.json").read_text())
    assert bench["value"] > 0 and bench["device"]["platform"] == "cpu"
    assert "rows identical across G=[1, 2]" in proc.stdout
    demo = tmp_path / "out" / "demo_torch" / "Processed"
    assert len(list(demo.glob("*/*-flame-position.txt"))) == 4
    assert len(list((tmp_path / "out" / "library_torch" / "videos")
                    .glob("*.cihx"))) == 3


@pytest.mark.parametrize("script,flags,expect", [
    ("demo_torch.py", ["--no-images", "--no-sequences"],
     ["Processing: Nova", "Processing: Mini", "Processing complete!"]),
    ("library_torch.py", [],
     ["lib-run-3-001.cihx: ", "first recording velocity history"]),
], ids=["demo", "library"])
def test_examples_run_on_the_cpu(tmp_path, script, flags, expect):
    """The port's two examples run to their end on the CPU, as scripts."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), str(tmp_path / "work"),
         "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for text in expect:
        assert text in proc.stdout, text


def _port_files():
    return (sorted((REPO / "hsip_tpu_torch").rglob("*.py"))
            + sorted((REPO / "examples").glob("*_torch.py"))
            + sorted((REPO / "tools").glob("*_torch.py"))
            + [REPO / "chip_smoke.py", REPO / "bench_torch.py"])


def _imported_roots(path):
    """Top-level package of every module an import statement names
    (relative imports resolve inside the port)."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_never_import_jax():
    """No module of the port (nor chip_smoke.py, bench_torch.py or the
    tools' ``*_torch.py``) imports jax, at any depth
    of the file (AST scan, so lazy imports inside functions count too)."""
    offenders = [str(f) for f in _port_files() if "jax" in _imported_roots(f)]
    assert not offenders
    scanned = {str(f.relative_to(REPO)) for f in _port_files()}
    assert {"hsip_tpu_torch/collection.py", "hsip_tpu_torch/track/fused.py",
            "hsip_tpu_torch/track/batch.py", "hsip_tpu_torch/pipeline.py",
            "hsip_tpu_torch/utils/logging.py", "hsip_tpu_torch/utils/checkpoint.py",
            "hsip_tpu_torch/utils/summary.py", "chip_smoke.py",
            "hsip_tpu_torch/cli.py", "hsip_tpu_torch/parallel/__init__.py",
            "hsip_tpu_torch/parallel/processor.py",
            "hsip_tpu_torch/parallel/mesh.py", "hsip_tpu_torch/parallel/sharding.py",
            "hsip_tpu_torch/parallel/dryrun.py",
            "examples/demo_torch.py", "examples/library_torch.py",
            "bench_torch.py", "tools/stage_profile_torch.py",
            "tools/pipeline_trace_torch.py"} <= scanned


def test_port_sources_never_import_the_jax_package():
    """No module of the port (nor chip_smoke.py, bench_torch.py or the
    tools' ``*_torch.py``) imports hsip_tpu or any
    hsip_tpu.* module; hsip_tpu_torch is its own root."""
    offenders = [str(f) for f in _port_files() if "hsip_tpu" in _imported_roots(f)]
    assert not offenders
    assert "hsip_tpu_torch" in _imported_roots(REPO / "chip_smoke.py")


@pytest.mark.parametrize("where", ["repo", "alone", "port_only"])
def test_chip_smoke_refuses_without_card_or_port(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result on a machine
    without CUDA, and in a directory holding nothing else of the repo. Its
    start check asks only for the port: beside hsip_tpu_torch/ alone (no
    hsip_tpu/) it gets as far as the card check."""
    if where != "alone" and torch.cuda.is_available():
        pytest.skip("with a card, chip_smoke.py runs in full")
    script = REPO / "chip_smoke.py"
    if where != "repo":
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    if where == "port_only":
        shutil.copytree(REPO / "hsip_tpu_torch", tmp_path / "hsip_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=str(script.parent))
    assert proc.returncode != 0
    assert proc.stdout == ""
    expected = "checkout" if where == "alone" else "torch.cuda.is_available"
    assert expected in proc.stderr
