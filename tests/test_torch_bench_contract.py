"""Contract tests for ``bench_torch.py`` and the port's two stage tools.

``bench_torch.py`` prints ONE JSON line under 2000 characters with
``metric``, ``value``, ``unit``, ``vs_baseline`` and ``device`` as its last
keys; without a card and without ``--device cpu`` it prints the error
object and no number. Its recording, its deadline guard and its per-file
rows are held against ``bench.py`` (JAX on the CPU). The tools run to
their end on the CPU at tiny sizes, and ``--trace`` fails without device
events instead of reporting an idle share of 0.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TINY = ["--frames", "16", "--height", "64", "--width", "256", "--videos", "2",
        "--repeat", "1", "--baseline-sample", "4", "--videos16", "0"]
HEADLINE = ["metric", "value", "unit", "vs_baseline", "device"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The runs here are tiny: one intra-op thread each keeps them from
    contending with the suite's other workers for every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench_torch():
    return _load("bench_torch_mod", REPO / "bench_torch.py")


@pytest.fixture(scope="module")
def bench_jax():
    return _load("bench_jax_mod", REPO / "bench.py")


@pytest.fixture(scope="module")
def stage_profile():
    return _load("stage_profile_torch_mod", REPO / "tools" / "stage_profile_torch.py")


@pytest.fixture(scope="module")
def pipeline_trace():
    return _load("pipeline_trace_torch_mod", REPO / "tools" / "pipeline_trace_torch.py")


def _run(script, *argv, timeout=120):
    """The script in its own process (what the contract is about)."""
    return subprocess.run([sys.executable, str(REPO / script), *map(str, argv)],
                          capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def _main(module, capsys, *argv):
    """``module.main(argv)`` in this process: (exit code, stdout, stderr)."""
    rc = module.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    return rc, out, err


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("with a card the default device runs")


@pytest.mark.parametrize("mode", [
    ["--mode", "both"],
    ["--mode", "single", "--scan", "host"],
    ["--mode", "library"],
], ids=["both", "single-host-scan", "library"])
def test_cpu_run_prints_one_line_with_the_headline_last(tmp_path, capsys, bench_torch,
                                                       mode):
    samples = tmp_path / "samples.json"
    rc, out, err = _main(bench_torch, capsys, "--device", "cpu", *TINY, *mode,
                         "--samples-out", samples)
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines
    assert len(lines[0]) < 2000
    result = json.loads(lines[0])
    assert list(result)[-5:] == HEADLINE
    assert result["metric"] == "mraw_frames_per_sec_per_chip_decode_track"
    assert result["unit"] == "frames/s"
    assert result["value"] > 0 and result["vs_baseline"] > 0
    assert result["device"] == {"platform": "cpu", "kind": result["device"]["kind"],
                                "count": 1}
    assert result["build_s"] is None  # nothing is built for the CPU
    assert result["scipy_serial_fps"] > 0 and result["baseline"].startswith("host")
    assert result["samples_file"] == str(samples)
    detail = json.loads(samples.read_text())
    assert detail["value"] == result["value"]
    # The CPU runs the kernels' plain versions: no launch anywhere.
    assert all(n == [0, 0] for n in result["launches"].values())
    if mode[1] == "both":
        assert result["rows_checked"].startswith("per-file loop == library on all 2")
        assert result["library_group_paths"] == ["fused"]
        assert set(result["launches"]) == {"per_file", "library", "device_compute"}
        assert detail["samples"]["per_file_s"] and detail["samples"]["library_s"]
        assert result["single_video_fps"] > 0 and result["library_fps"] > 0
        assert result["device_compute_fps"] > 0
        # The host's float64 tables are a part of the scan stage, kept apart.
        ms = result["device_compute_ms"]
        assert 0 < ms["scan_host_tables"] <= ms["scan"] and ms["map"] > 0
        assert "scan_phase" in detail["single_stages"]
    elif mode[1] == "single":
        assert result["single_mode"] == "one recording"
        assert "library_fps" not in result and "rows_checked" not in result
        assert result["value"] == result["single_video_fps"]
    else:
        assert "single_video_fps" not in result
        assert result["value"] == result["library_fps"]


def test_the_script_prints_only_its_line(tmp_path):
    proc = _run("bench_torch.py", "--device", "cpu", *TINY, "--mode", "library",
                "--samples-out", tmp_path / "samples.json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = proc.stdout.strip().splitlines()
    assert json.loads(line)["value"] > 0


def test_no_card_is_an_error_object_and_no_number(tmp_path):
    _no_card()
    samples = tmp_path / "samples.json"
    proc = _run("bench_torch.py", *TINY, "--samples-out", samples)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["value"] is None and result["vs_baseline"] is None
    assert "CUDA is not available" in result["error"]
    assert list(result)[-5:] == HEADLINE
    assert not samples.exists()


def test_host_scan_is_single_mode_only(capsys, bench_torch):
    with pytest.raises(SystemExit) as exit_:
        bench_torch.main(["--device", "cpu", "--scan", "host"])
    out, err = capsys.readouterr()
    assert exit_.value.code == 2 and "single-video mode only" in err
    assert out == ""


def test_deadline_guard_decides_as_bench_py(bench_torch, bench_jax):
    port, jax_guard = bench_torch._repeats_deadline_note, bench_jax._repeats_deadline_note
    grid = [(rep, elapsed, est, budget)
            for rep in (0, 3, 4, 6, 11)
            for elapsed in (0.0, 200.0, 700.0, 1000.0, 1400.0)
            for est in (0.5, 40.0, 120.0, 400.0)
            for budget in (60.0, 1500.0)]
    for rep, elapsed, est, budget in grid:
        assert (port(rep, 12, elapsed, est, budget) is None) == \
            (jax_guard(rep, 12, elapsed, est, budget) is None), (rep, elapsed, est, budget)
    assert "6 of 12" in port(6, 12, 1000.0, 120.0, 1500.0)
    assert port(3, 12, 1400.0, 200.0, 1500.0) is None  # never below 4 pairs


@pytest.mark.parametrize("shape", [(16, 64, 256), (24, 48, 200)], ids=str)
def test_build_recording_writes_bench_py_bytes(tmp_path, bench_torch, bench_jax, shape):
    port = Path(bench_torch.build_recording(tmp_path / "port", *shape))
    ref = Path(bench_jax.build_recording(tmp_path / "jax", *shape))
    assert port.name == ref.name == "bench-run-1-001.cihx"
    for suffix in (".cihx", ".mraw"):
        assert port.with_suffix(suffix).read_bytes() == ref.with_suffix(suffix).read_bytes()


def test_per_file_rows_equal_bench_py(tmp_path, bench_torch, bench_jax):
    """The same 2-video library through both per-file loops (bench.py's on
    JAX's CPU backend): the same integer positions and the same printed
    rows; the port's library mode gives the same rows again."""
    from hsip_tpu.track import FlameDetectorConfig as JaxConfig
    from hsip_tpu_torch.track import FlameDetectorConfig

    meta = bench_torch.build_recording(tmp_path, 32, 64, 256)
    lib = bench_torch.build_library(tmp_path, 2, meta)
    dev = torch.device("cpu")
    port_outs, _ = bench_torch.run_per_file_pipeline(lib, FlameDetectorConfig(), dev)
    jax_outs, _ = bench_jax.run_per_file_pipeline(lib, JaxConfig(), None, "device")

    def printed(rows):
        return [repr((int(f), float(t), int(p), float(m), bool(d)))
                for f, t, p, m, d in rows]

    assert len(port_outs) == len(jax_outs) == 2
    for p, j in zip(port_outs, jax_outs):
        assert len(p.rows) > 5
        assert [r[2] for r in p.rows] == [int(r[2]) for r in j.rows]
        assert printed(p.rows) == printed(j.rows)
    lib_outs, paths = bench_torch.run_collection_pipeline(lib, FlameDetectorConfig(), dev)
    assert paths == ["fused"]
    bench_torch.check_rows(port_outs, lib_outs, ["a", "b"])


def test_rows_that_differ_are_an_error(bench_torch):
    class Out:
        def __init__(self, rows):
            self.rows = rows

    same = [Out([(1, 0.1, 5, 0.5, False)]), Out([])]
    bench_torch.check_rows(same, list(same), ["a", "b"])
    with pytest.raises(bench_torch.RowsDiffer, match="rows of b differ"):
        bench_torch.check_rows(same, [same[0], Out([(2, 0.2, 6, 0.6, False)])], ["a", "b"])
    with pytest.raises(bench_torch.RowsDiffer, match="library 1, over 2"):
        bench_torch.check_rows(same, same[:1], ["a", "b"])


def test_summarize_device_events_takes_the_union():
    from hsip_tpu_torch.utils.profiling import summarize_device_events

    events = [
        {"ph": "X", "cat": "kernel", "name": "scan", "ts": 0.0, "dur": 400.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 300.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "band", "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "band", "ts": 1050.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "unpack", "ts": 2000.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 5000.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 10.0},
    ]
    got = summarize_device_events(events, wall_s=0.01, top=2)
    # [0, 500] + [1000, 1150] + [2000, 2050] microseconds.
    assert got["device_busy_s"] == pytest.approx(700e-6)
    assert got["idle_share"] == pytest.approx(1 - 700e-6 / 0.01)
    assert got["device_events"] == 5
    assert [(k["name"], k["launches"]) for k in got["top_kernels"]] == [
        ("scan", 1), ("band", 2)]
    assert got["top_kernels"][1]["ms"] == pytest.approx(0.2)
    with pytest.raises(RuntimeError, match="no device events"):
        summarize_device_events(events[5:], wall_s=0.01)


def test_measurement_helpers_on_the_cpu():
    """The helpers the three scripts share: no wait, no launch and no card
    on the CPU."""
    import platform

    from hsip_tpu_torch.utils.profiling import device_info, launched_by, sync

    assert sync("cpu") is None
    assert launched_by(lambda: torch.ones(8).sum().item()) == (8.0, [0, 0])
    assert device_info(torch.device("cpu")) == {
        "platform": "cpu", "kind": platform.machine(), "count": 1}


def test_device_time_on_the_cpu_fails():
    from hsip_tpu_torch.utils.profiling import device_time

    with pytest.raises(RuntimeError, match="no device events"):
        device_time(lambda: torch.ones(64).sum(), "cpu")


STAGE_TINY = ["--device", "cpu", "--frames", "16", "--height", "64", "--width", "256",
              "--videos", "2", "--repeat", "1"]


def test_stage_profile_runs_on_the_cpu(tmp_path, capsys, stage_profile):
    cache = tmp_path / "cache"
    rc, out, err = _main(stage_profile, capsys, *STAGE_TINY, "--cache-dir", cache)
    assert rc == 0, err[-3000:]
    report = json.loads(out)
    assert report["device"]["platform"] == "cpu"
    for mode in ("single", "library"):
        assert report[mode]["rows"] > 0 and report[mode]["fps"] > 0
        assert report[mode]["launches"] == [0, 0]
        assert "read_gather" in report[mode]["stages"]
    assert report["library"]["videos"] == 2
    # The cache is reused: a second run synthesizes nothing.
    rc, out, err = _main(stage_profile, capsys, *STAGE_TINY, "--mode", "single",
                         "--cache-dir", cache)
    assert rc == 0 and "synthesizing" not in err


def test_stage_profile_trace_without_device_events_fails(tmp_path, capsys, stage_profile):
    rc, out, err = _main(stage_profile, capsys, *STAGE_TINY, "--mode", "single", "--trace",
                         "--cache-dir", tmp_path / "cache")
    assert rc == 1
    assert "no device events" in err
    assert out == ""


def test_pipeline_trace_rows_identical_across_groups_on_the_cpu(capsys, pipeline_trace):
    rc, out, err = _main(pipeline_trace, capsys, "--device", "cpu", "--videos", "4",
                         "--frames", "24", "--height", "64", "--width", "256",
                         "--groups", "1", "2", "--repeats", "1")
    assert rc == 0, err[-3000:]
    assert "rows identical across G=[1, 2]" in out
    assert "overlap_s=" in out and "tail_s=" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["rows_identical"] is True
    assert summary["device"]["platform"] == "cpu"
    assert summary["shape"] == [4, 24, 64, 256]
    assert {g: e["groups"] for g, e in summary["per_group"].items()} == {"1": 1, "2": 2}
    assert all(e["launches"] == [0, 0] for e in summary["per_group"].values())


@pytest.mark.parametrize("tool", ["stage_profile", "pipeline_trace"])
def test_tools_refuse_without_a_card(capsys, request, tool):
    _no_card()
    rc, out, err = _main(request.getfixturevalue(tool), capsys, "--frames", "16")
    assert rc == 2
    assert "CUDA is not available" in err
    assert out == ""
