"""The port's command line (``hsip_tpu_torch.cli``) against ``hsip_tpu.cli``.

Both ``main`` functions run here on the CPU (the port with ``--device cpu``,
where both kernels' plain PyTorch versions run; the JAX package on its CPU
platform) over tiny recordings made from a seed by the port's own writer.
The tables they write must be byte-identical (tolerance: none), ``--info``
must print the same characters, ``load_config`` must give equal
dataclasses, and the port's own rules (the device is named or the run
refuses, ``--mesh`` never runs with fewer slots than asked, a device fault
ends the run) are held. ``--library --mesh`` runs on CPU slots.
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import hsip_tpu.cli as jax_cli  # noqa: E402

import hsip_tpu_torch  # noqa: E402
import hsip_tpu_torch.cli as port_cli  # noqa: E402
import hsip_tpu_torch.pipeline as port_pipeline  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.kernels._build import KernelError  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

TOML = """
[[source]]
name = "Nova"
enabled = true
video_path = "{video_path}"
output_dir = "{output_dir}"
calibration = 0.001
use_absolute_time = true
skip_frames = [3]
detection_method = "gradient"
figure_style = "compact"

[[source.file_calibration]]
calibration = 0.000833333
position_offset = 1.0159
files = ["run-1-"]

[detector]
gaussian_sigma = 1.5
frame_diff_threshold = 5.0
"""

CPU = ["--device", "cpu"]
TABLES_ONLY = ["--no-images", "--no-sequences"]


def _write(directory, stem, n=25, seed=13, height=48, width=256, **flame):
    flame = dict(dict(x0=25.0, v0_px=6.0, ignition_frame=2), **flame)
    frames, _ = synthesize_flame_video(
        n, height=height, width=width, flame=FlameSpec(seed=seed, **flame))
    return write_recording(directory, stem, frames,
                           spec=CihxSpec(width=width, height=height,
                                         total_frames=n, record_rate=100_000,
                                         bit_depth=12))


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Two recordings of one shape (one with a DDT jump) and one of another."""
    tmp = tmp_path_factory.mktemp("torch_cli_videos")
    _write(tmp, "cli-run-1-a")
    _write(tmp, "cli-run-1-b", seed=5, x0=22.0, v0_px=5.0, ddt_frame=14,
           v_jump_px=20.0)
    _write(tmp, "cli-run-2-a", n=20, seed=8, height=32, width=384, v0_px=9.0)
    return tmp


@pytest.fixture()
def one_video(tmp_path):
    d = tmp_path / "vids"
    _write(d, "cli-run-1-a")
    return d


def _tables(out):
    return {p.name: p.read_bytes()
            for p in sorted(Path(out).glob("*-flame-position*.txt"))}


def _port(videos, out, *flags):
    return port_cli.main(["--video-path", str(videos), "--output-dir", str(out),
                          "--calibration", "0.000833333", "--quiet",
                          *CPU, *flags])


def _jax(videos, out, *flags):
    return jax_cli.main(["--video-path", str(videos), "--output-dir", str(out),
                         "--calibration", "0.000833333", "--quiet",
                         "--platform", "cpu", *flags])


# ---- load_config, the parser ----

def _as_dicts(loaded):
    sources, detector = loaded
    return [dataclasses.asdict(s) for s in sources], dataclasses.asdict(detector)


def test_load_config_equals_the_jax_package(tmp_path, videos):
    toml = tmp_path / "run.toml"
    toml.write_text(TOML.format(video_path=str(videos),
                                output_dir=str(tmp_path / "out")))
    js = tmp_path / "run.json"
    js.write_text(json.dumps({
        "source": [{"name": "J", "video_path": str(videos),
                    "output_dir": str(tmp_path / "o"), "trigger_frame": 4,
                    "file_calibrations": [{"calibration": 0.002,
                                           "files": ["a", "b"]}]}],
        "detector": {"exit_margin_px": 20},
    }))
    for path in (toml, js, REPO / "examples" / "run.toml"):
        got, want = port_cli.load_config(path), jax_cli.load_config(path)
        assert _as_dicts(got) == _as_dicts(want), path
        assert [(s.video_path, s.output_dir) for s in got[0]] == \
            [(s.video_path, s.output_dir) for s in want[0]]
    sources, det = port_cli.load_config(toml)
    assert sources[0].skip_frames == [3] and det.gaussian_sigma == 1.5
    assert sources[0].get_calibration_for_file("cli-run-1-a.cihx") == \
        (0.000833333, 1.0159)
    assert type(sources[0]).__module__.startswith("hsip_tpu_torch.")


@pytest.mark.parametrize("doc", [
    {"source": [{"name": "X", "skip_frame": [3]}]},
    {"detector": {"bogus_knob": 1}},
    {"source": [{"name": "X", "base_path": "/data"}]},
    {"source": [{"name": "X", "figure_style": "wide"}]},
    {"source": [{"name": "X", "detection_method": "guess"}]},
], ids=["source-key", "detector-key", "base_path", "figure_style",
        "detection_method"])
def test_load_config_rejections_read_alike(tmp_path, doc):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as want:
        jax_cli.load_config(p)
    with pytest.raises(ValueError) as got:
        port_cli.load_config(p)
    assert str(got.value) == str(want.value)


def test_load_config_rejects_other_formats(tmp_path):
    p = tmp_path / "run.yaml"
    p.write_text("source: []")
    with pytest.raises(ValueError, match="Unsupported config format"):
        port_cli.load_config(p)


def test_parser_defaults_equal_the_jax_package():
    port = vars(port_cli.build_parser().parse_args([]))
    jax = vars(jax_cli.build_parser().parse_args([]))
    assert set(port) - set(jax) == {"device"}
    assert set(jax) - set(port) == {"platform"}
    for dest in set(port) & set(jax):
        assert port[dest] == jax[dest], dest
    assert port["device"] is None and port["backend"] is None
    # --watch and --mesh without a value take the same constants.
    argv = ["--watch", "--library", "--mesh"]
    port = port_cli.build_parser().parse_args(argv)
    jax = jax_cli.build_parser().parse_args(argv)
    assert (port.watch, port.mesh) == (jax.watch, jax.mesh) == (10.0, 0)
    with pytest.raises(SystemExit):
        port_cli.build_parser().parse_args(["--backend", "tpu"])


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == \
        f"hsip_tpu_torch {hsip_tpu_torch.__version__}"


# ---- the routes, tables byte for byte ----

@pytest.mark.parametrize("method", ["combined", "threshold", "gradient",
                                    "half_maximum"])
def test_per_file_tables_equal_the_jax_cli(videos, tmp_path, method, capsys):
    flags = [*TABLES_ONLY, "--detection-method", method]
    assert _port(videos, tmp_path / "port", *flags) == 0
    assert _jax(videos, tmp_path / "jax", *flags) == 0
    got, want = _tables(tmp_path / "port"), _tables(tmp_path / "jax")
    assert len(want) >= 3 and got == want
    assert "Processing complete!" in capsys.readouterr().out


def test_library_tables_equal_the_jax_cli_and_the_per_file_run(videos, tmp_path):
    assert _port(videos, tmp_path / "port-lib", "--library", *TABLES_ONLY) == 0
    assert _jax(videos, tmp_path / "jax-lib", "--library", *TABLES_ONLY) == 0
    assert _port(videos, tmp_path / "port-file", *TABLES_ONLY) == 0
    want = _tables(tmp_path / "jax-lib")
    assert any("post-DDT" in name for name in want)
    assert _tables(tmp_path / "port-lib") == want
    assert _tables(tmp_path / "port-file") == want


@pytest.mark.parametrize("backend", ["gpu", "device", "exact"])
def test_explicit_backends_write_the_same_tables(one_video, tmp_path, backend,
                                                 monkeypatch):
    if backend == "exact":
        # The float64 host backend needs no device: no card, no --device.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        rc = port_cli.main(["--video-path", str(one_video), "--output-dir",
                            str(tmp_path / "a"), "--calibration", "0.000833333",
                            "--quiet", "--backend", "exact", *TABLES_ONLY])
    else:
        rc = _port(one_video, tmp_path / "a", "--backend", backend, *TABLES_ONLY)
    assert rc == 0
    assert _port(one_video, tmp_path / "b", *TABLES_ONLY) == 0
    assert _tables(tmp_path / "a") == _tables(tmp_path / "b") != {}


def test_flags_override_config_sources(videos, tmp_path, monkeypatch):
    cfg_path = tmp_path / "run.toml"
    cfg_path.write_text(TOML.format(video_path=str(videos),
                                    output_dir=str(tmp_path / "o")))
    captured = []

    def fake_process(cfg, *a, **k):
        captured.append((cfg, k))
        return []

    monkeypatch.setattr(port_pipeline, "process_video_source", fake_process)
    rc = port_cli.main(["--config", str(cfg_path), "--relative-time",
                        "--trigger-frame", "7", "--calibration", "0.002",
                        "--position-offset", "0.5", "--no-images", "--quiet",
                        "--figure-style", "full", "--detection-method",
                        "threshold", *CPU])
    assert rc == 0 and len(captured) == 1
    cfg, kwargs = captured[0]
    assert cfg.trigger_frame == 7 and cfg.use_absolute_time is False
    assert cfg.calibration == 0.002 and cfg.position_offset == 0.5
    assert cfg.save_frame_images is False and cfg.figure_style == "full"
    assert cfg.detection_method == "threshold"
    # The device is resolved once by the CLI and handed to the runner.
    assert kwargs["device"] == torch.device("cpu")


def test_auto_backend_is_device_without_figures_and_gpu_with(one_video, tmp_path,
                                                             monkeypatch):
    seen = []

    def spy(cfg, det, backend="gpu", **kw):
        seen.append(backend)
        return []

    monkeypatch.setattr(port_pipeline, "process_video_source", spy)
    assert _port(one_video, tmp_path / "a", *TABLES_ONLY) == 0
    assert seen == ["device"]
    seen.clear()
    assert _port(one_video, tmp_path / "b", "--no-sequences") == 0
    assert seen == ["gpu"]


def test_resume_reprocesses_nothing(videos, tmp_path, capsys):
    out = tmp_path / "out"
    args = ["--video-path", str(videos), "--output-dir", str(out),
            "--calibration", "0.001", *TABLES_ONLY, *CPU]
    assert port_cli.main(args) == 0
    first = capsys.readouterr().out
    assert first.count("Loading:") == 3
    tables = _tables(out)
    stamps = {p.name: p.stat().st_mtime_ns for p in out.glob("*.txt")}
    assert port_cli.main([*args, "--resume"]) == 0
    second = capsys.readouterr().out
    assert "Loading:" not in second
    assert second.count("already complete") == 3
    assert _tables(out) == tables
    assert {p.name: p.stat().st_mtime_ns for p in out.glob("*.txt")} == stamps
    # And library mode resumes from its own ledger.
    lib = tmp_path / "lib"
    assert _port(videos, lib, "--library", *TABLES_ONLY) == 0
    stamps = {p.name: p.stat().st_mtime_ns for p in lib.glob("*.txt")}
    assert _port(videos, lib, "--library", "--resume", *TABLES_ONLY) == 0
    assert {p.name: p.stat().st_mtime_ns for p in lib.glob("*.txt")} == stamps


# ---- --info ----

def test_info_prints_what_hsip_prints(videos, tmp_path, capsys, monkeypatch):
    vdir = tmp_path / "videos"
    shutil.copytree(videos, vdir)
    (vdir / "garbage.cihx").write_bytes(b"\x01nope" * 40)
    out_dir = tmp_path / "explicit-out"
    argv = ["--video-path", str(vdir), "--output-dir", str(out_dir),
            "--calibration", "0.0005", "--info"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    # No card and no --device: --info touches no device and works anyway.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "cli-run-1-a.cihx: 25 frames 48x256" in got and "UNREADABLE" in got
    assert not out_dir.exists()


def test_info_empty_dir(tmp_path, capsys):
    assert port_cli.main(["--video-path", str(tmp_path), "--info"]) == 1
    assert "No recordings found" in capsys.readouterr().err


# ---- exit 2 ----

def test_no_sources_exits_2(capsys):
    assert port_cli.main([]) == 2
    assert "No sources" in capsys.readouterr().err


@pytest.mark.parametrize("flags,text", [
    (["--coordinator", "127.0.0.1:1"], "require --distributed"),
    (["--num-processes", "2"], "require --distributed"),
    (["--process-id", "0"], "require --distributed"),
    (["--mesh"], "--mesh requires --library"),
    (["--library", "--mesh", "-1"], "must be positive"),
    (["--library", "--backend", "exact"], "incompatible with --library"),
    (["--library", "--mesh", "64", "--device", "cuda"],
     "--mesh 64: only 1 local device(s) available"),
    (["--library", "--mesh", "2", "--device", "cuda"],
     "--mesh 2: only 1 local device(s) available"),
    (["--device", "definitely_not_a_device"], "definitely_not_a_device"),
], ids=["coordinator", "num-processes", "process-id", "mesh-alone",
        "mesh-negative", "library-backend", "mesh-all", "mesh-2", "bad-device"])
def test_argument_checks_exit_2_and_write_nothing(one_video, tmp_path, capsys,
                                                  monkeypatch, flags, text):
    """On a machine with one card: a mesh of more cards than that exits 2,
    it never runs with fewer slots or unsharded."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "o"
    argv = ["--video-path", str(one_video), "--output-dir", str(out),
            "--quiet", *TABLES_ONLY, *flags]
    if "--device" not in flags:
        argv += CPU
    assert port_cli.main(argv) == 2
    captured = capsys.readouterr()
    assert text in captured.err and len(captured.err.strip().splitlines()) == 1
    assert "Could not process" not in captured.out
    assert not out.exists()


def test_shared_argument_checks_read_as_in_the_jax_cli(one_video, tmp_path, capsys):
    for flags in (["--coordinator", "127.0.0.1:1"], ["--mesh"],
                  ["--library", "--mesh", "-1"]):
        argv = ["--video-path", str(one_video), "--output-dir",
                str(tmp_path / "o"), "--quiet", *flags]
        assert jax_cli.main(argv) == 2
        want = capsys.readouterr().err
        assert port_cli.main(argv) == 2
        assert capsys.readouterr().err == want


@pytest.mark.parametrize("mesh", [["--mesh"], ["--mesh", "4"]],
                         ids=["mesh-all", "mesh-4"])
def test_library_mesh_writes_the_jax_tables(videos, tmp_path, capsys, mesh):
    """``--library --mesh [N]`` on CPU slots (one when N is omitted) writes
    the tables of ``hsip --library --mesh`` and of plain ``--library``."""
    assert _jax(videos, tmp_path / "jax", "--library", *mesh, *TABLES_ONLY) == 0
    capsys.readouterr()
    assert port_cli.main(["--video-path", str(videos), "--output-dir",
                          str(tmp_path / "port"), "--calibration", "0.000833333",
                          *CPU, "--library", *mesh, *TABLES_ONLY]) == 0
    slots = int(mesh[1]) if len(mesh) > 1 else 1
    assert f"Sharding video axis over {slots} devices" in capsys.readouterr().out
    assert _port(videos, tmp_path / "plain", "--library", *TABLES_ONLY) == 0
    want = _tables(tmp_path / "jax")
    assert len(want) >= 3
    assert _tables(tmp_path / "port") == want == _tables(tmp_path / "plain")


def test_mesh_takes_the_ranks_own_cards(monkeypatch):
    """Which slots ``--mesh`` may take: every local card; under
    ``--distributed`` disjoint cards a rank when there are enough, else the
    rank's own card, shared; a card named by index alone; N CPU slots."""
    class Rank1Of2:
        rank, size = 1, 2

    def cuda(*idx):
        return [torch.device("cuda", i) for i in idx]

    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    slots = port_cli._mesh_devices
    assert slots(0, torch.device("cuda"), None, None) == cuda(0, 1, 2, 3)
    assert slots(0, torch.device("cuda", 1), None, Rank1Of2()) == cuda(2, 3)
    assert slots(0, torch.device("cuda", 2), "cuda:2", None) == cuda(2)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert slots(0, torch.device("cuda", 0), None, Rank1Of2()) == cuda(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert slots(0, torch.device("cuda", 0), None, Rank1Of2()) == cuda(0)
    assert slots(3, torch.device("cpu"), "cpu", None) == [torch.device("cpu")] * 3
    assert slots(0, torch.device("cpu"), "cpu", None) == [torch.device("cpu")]


@pytest.mark.parametrize("flags", [[], ["--library"], ["--device", "cuda"],
                                   ["--device", "cuda:0"], ["--watch", "0.1"]],
                         ids=["per-file", "library", "cuda", "cuda:0", "watch"])
def test_no_card_and_no_cpu_named_exits_2(one_video, tmp_path, capsys,
                                          monkeypatch, flags):
    """Never a run that carries on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o"
    assert port_cli.main(["--video-path", str(one_video), "--output-dir",
                          str(out), *TABLES_ONLY, *flags]) == 2
    captured = capsys.readouterr()
    assert "CUDA is not available" in captured.err
    assert len(captured.err.strip().splitlines()) == 1
    assert not out.exists() and "Loading" not in captured.out


def test_device_index_past_the_cards_exits_2(one_video, tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "o"
    assert port_cli.main(["--video-path", str(one_video), "--output-dir",
                          str(out), *TABLES_ONLY, "--device", "cuda:99"]) == 2
    assert "--device cuda:99" in capsys.readouterr().err
    assert not out.exists()


def test_watch_requires_output_dir(tmp_path, capsys):
    cfg = tmp_path / "w.json"
    cfg.write_text(json.dumps(
        {"source": [{"name": "W", "video_path": str(tmp_path)}]}))
    assert port_cli.main(["--config", str(cfg), "--watch", *CPU]) == 2
    assert "requires an output dir" in capsys.readouterr().err


# ---- --watch ----

def _watch(vdir, out, *flags):
    return port_cli.main(["--video-path", str(vdir), "--output-dir", str(out),
                          "--calibration", "0.001", *TABLES_ONLY, *CPU,
                          "--watch", "0.2", *flags])


def test_watch_picks_up_new_recordings(one_video, tmp_path, monkeypatch, capsys):
    """The first pass processes what is there, a later poll picks up a
    recording that arrives afterwards, and nothing is reprocessed."""
    out = tmp_path / "out"
    passes = {"n": 0}

    def fake_sleep(_secs):
        passes["n"] += 1
        if passes["n"] == 2:
            _write(one_video, "cli-run-1-late", n=20, seed=77)
        if passes["n"] >= 4:
            raise KeyboardInterrupt

    import time as time_mod

    monkeypatch.setattr(time_mod, "sleep", fake_sleep)
    assert _watch(one_video, out) == 0
    outtext = capsys.readouterr().out
    assert "Watching for new recordings every 0.2 s" in outtext
    assert "Watch pass complete (1 new)" in outtext
    assert "Watch stopped" in outtext
    assert (out / "cli-run-1-a-flame-position.txt").exists()
    assert (out / "cli-run-1-late-flame-position.txt").exists()
    assert outtext.count("Loading: cli-run-1-a.cihx") == 1
    # Later passes stay quiet: the late recording has no load banner.
    assert "Loading: cli-run-1-late.cihx" not in outtext


@pytest.mark.parametrize("library,warning", [(False, "Could not process"),
                                             (True, "Could not load")])
def test_watch_corrupt_file_warns_once(one_video, tmp_path, monkeypatch, capsys,
                                       library, warning):
    """An unchanged failed file warns once, and again only when it changes."""
    bad = one_video / "zz-corrupt.cihx"
    bad.write_bytes(b"\x00" * 64)
    out = tmp_path / "out"
    passes = {"n": 0}

    def fake_sleep(_secs):
        passes["n"] += 1
        if passes["n"] == 3:
            bad.write_bytes(b"\x00" * 128)
        if passes["n"] >= 5:
            raise KeyboardInterrupt

    import time as time_mod

    monkeypatch.setattr(time_mod, "sleep", fake_sleep)
    assert _watch(one_video, out, *(["--library"] if library else [])) == 0
    assert capsys.readouterr().out.count(warning) == 2
    assert (out / "cli-run-1-a-flame-position.txt").exists()


@pytest.mark.parametrize("flags", [[], ["--watch", "0.2"]], ids=["run", "watch"])
def test_exact_backend_passes_over_a_corrupt_recording(videos, tmp_path,
                                                       monkeypatch, capsys,
                                                       flags):
    """``--backend exact`` runs on no device, and one unreadable recording
    must not end it: a warning, the file under ``failures``, exit 0, and the
    good recordings' tables equal to ``hsip --backend exact``'s."""
    src = tmp_path / "src"
    shutil.copytree(videos, src)
    (src / "zz-corrupt.cihx").write_bytes(b"\x00" * 64)
    import time as time_mod

    def stop(_secs):
        raise KeyboardInterrupt

    monkeypatch.setattr(time_mod, "sleep", stop)
    assert _port(src, tmp_path / "port", "--backend", "exact", *TABLES_ONLY,
                 *flags) == 0
    assert capsys.readouterr().out.count("Could not process") == 1
    assert _jax(src, tmp_path / "jax", "--backend", "exact", *TABLES_ONLY) == 0
    want = _tables(tmp_path / "jax")
    assert len({n.split("-flame")[0] for n in want}) == 3
    assert _tables(tmp_path / "port") == want
    summary = json.loads((tmp_path / "port" / "run-summary.json").read_text())
    assert [f["file"] for f in summary["failures"]] == ["zz-corrupt.cihx"]
    assert len(summary["files"]) == 3


def test_watch_stop_sentinel(one_video, tmp_path, monkeypatch, capsys):
    """A stale sentinel is removed at the start; one made during the watch
    stops the loop at the next poll."""
    out = tmp_path / "out"
    out.mkdir()
    (out / ".hsip-watch-stop").touch()
    passes = {"n": 0}

    def fake_sleep(_secs):
        passes["n"] += 1
        (out / ".hsip-watch-stop").touch()
        if passes["n"] >= 3:  # safety: the sentinel should stop us first
            raise KeyboardInterrupt

    import time as time_mod

    monkeypatch.setattr(time_mod, "sleep", fake_sleep)
    assert _watch(one_video, out) == 0
    assert "Watch stopped (shutdown requested)" in capsys.readouterr().out
    assert passes["n"] == 1
    assert (out / "cli-run-1-a-flame-position.txt").exists()


# ---- device faults, the profile ----

@pytest.mark.parametrize("flags", [[], ["--watch", "0.1"]], ids=["run", "watch"])
def test_device_fault_ends_the_run(one_video, tmp_path, monkeypatch, flags):
    """A kernel that does not build or launch is no recording's fault: it
    leaves `main`, in serve mode too, and nothing polls a second time."""
    calls, sleeps = [], []

    def broken(*args, **kwargs):
        calls.append(args)
        raise KernelError("nvcc failed")

    import time as time_mod

    monkeypatch.setattr(port_pipeline, "process_video_file", broken)
    monkeypatch.setattr(time_mod, "sleep", lambda s: sleeps.append(s))
    with pytest.raises(KernelError):
        port_cli.main(["--video-path", str(one_video), "--output-dir",
                       str(tmp_path / "o"), *TABLES_ONLY, "--quiet", *CPU,
                       *flags])
    assert len(calls) == 1 and sleeps == []


def test_profile_dir_leaves_a_trace(one_video, tmp_path):
    prof = tmp_path / "trace"
    assert _port(one_video, tmp_path / "out", *TABLES_ONLY,
                 "--profile-dir", str(prof)) == 0
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert "traceEvents" in traces[0].read_text()[:4096]
    assert (tmp_path / "out" / "cli-run-1-a-flame-position.txt").exists()


def test_entry_survives_a_closed_pipe(monkeypatch):
    """`hsip-torch --info | head`: a closed stdout is a quiet exit 0."""
    import os

    def closed(argv=None):
        raise BrokenPipeError

    duped = []

    def fake_dup2(fd, target):
        duped.append(target)
        os.close(fd)

    # Undone before the test ends: pytest's own capture uses os.dup2.
    with monkeypatch.context() as m:
        m.setattr(port_cli, "main", closed)
        m.setattr(os, "dup2", fake_dup2)
        assert port_cli.entry() == 0
    assert len(duped) == 1


# ---- figures without matplotlib (an optional dependency) ----


@pytest.mark.parametrize("flags", [[], ["--library"], ["--no-sequences"],
                                   ["--no-images"]],
                         ids=["per-file", "library", "images", "sequences"])
def test_figures_without_matplotlib_exit_2_and_write_nothing(one_video, tmp_path,
                                                             capsys, monkeypatch,
                                                             flags):
    """The default route (figures on) on a machine without matplotlib is
    refused before any file is opened. It used to process each recording,
    fail it at the figure step (no table written) and exit 0; --library
    wrote the tables and warned about every figure."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "o"
    argv = ["--video-path", str(one_video), "--output-dir", str(out), *CPU, *flags]
    assert port_cli.main(argv) == 2
    captured = capsys.readouterr()
    assert captured.err.strip() == port_pipeline._FIGURES_NEED_MATPLOTLIB
    assert "--no-images --no-sequences" in captured.err and not captured.out
    assert not out.exists()


def test_tables_only_need_no_matplotlib(one_video, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert _port(one_video, tmp_path / "o", *TABLES_ONLY) == 0
    assert _port(one_video, tmp_path / "lib", *TABLES_ONLY, "--library") == 0
    assert _tables(tmp_path / "o") and _tables(tmp_path / "o") == _tables(tmp_path / "lib")


@pytest.mark.parametrize("runner", ["file", "source", "library"])
def test_runners_refuse_figures_without_matplotlib(one_video, tmp_path, monkeypatch,
                                                   runner):
    """The Python entry points raise before any recording is opened."""
    from hsip_tpu_torch.track.config import VideoSourceConfig

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = VideoSourceConfig(name="S", save_stacked_sequences=runner == "file")
    cfg.video_path = str(one_video)
    cfg.output_dir = str(tmp_path / "o")
    call = {
        "file": lambda: port_pipeline.process_video_file(
            next(one_video.glob("*.cihx")), cfg, verbose=False, save_images=False,
            device="cpu"),
        "source": lambda: port_pipeline.process_video_source(cfg, verbose=False,
                                                             device="cpu"),
        "library": lambda: port_pipeline.process_video_source_library(
            cfg, verbose=False, device="cpu"),
    }[runner]
    with pytest.raises(ModuleNotFoundError, match="--no-images --no-sequences"):
        call()
    assert not (tmp_path / "o").exists()
