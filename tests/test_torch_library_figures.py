"""The port's figure route, byte for byte, against itself and ``hsip_tpu``.

The port of ``tests/test_library_figures.py``. Library mode replays the
per-file figure path per recording, and ``backend="device"`` collects its
figures from a host-scan replay (``hsip_tpu_torch.pipeline``). Every run
here is on the CPU (``device="cpu"``); the port's PNGs must equal each
other's and those of ``hsip_tpu``'s run of the same route (JAX ``tpu`` for
the port's ``gpu``), and so must the tables. Tolerance: none.

Each route renders once per module (the render pool is spawned, so a
figure run costs seconds); the tests only compare.
"""

from __future__ import annotations

import pytest

pytest.importorskip("matplotlib")
torch = pytest.importorskip("torch")

import hsip_tpu.pipeline as jax_pipeline  # noqa: E402
from hsip_tpu.track import FileCalibration as JaxFileCalibration  # noqa: E402
from hsip_tpu.track import VideoSourceConfig as JaxSourceConfig  # noqa: E402

import hsip_tpu_torch.pipeline as port_pipeline  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.track.config import FileCalibration, VideoSourceConfig  # noqa: E402

from test_torch_library import pin_reference_puts  # noqa: E402


@pytest.fixture(autouse=True)
def _reference_puts_copy(monkeypatch):
    """The JAX package's library runs here put private copies
    (``test_torch_library.pin_reference_puts``)."""
    pin_reference_puts(monkeypatch)


@pytest.fixture(scope="module")
def fig_library(tmp_path_factory):
    d = tmp_path_factory.mktemp("fig-lib")
    for i, seed in enumerate((11, 13)):
        frames, _ = synthesize_flame_video(
            10, height=32, width=192,
            flame=FlameSpec(x0=20, v0_px=8, ignition_frame=2, seed=seed),
        )
        write_recording(
            d, f"figlib-run-{i + 1}-001", frames,
            spec=CihxSpec(width=192, height=32, total_frames=10,
                          record_rate=50_000),
        )
    return d


def _source(library_dir, out, jax, figures):
    cls, cal = ((JaxSourceConfig, JaxFileCalibration) if jax
                else (VideoSourceConfig, FileCalibration))
    cfg = cls(name="FigLib", enabled=True, figure_style="compact",
              save_frame_images=figures, save_stacked_sequences=figures)
    cfg.video_path = str(library_dir)
    cfg.output_dir = str(out)
    cfg.file_calibrations = [
        cal(calibration=0.000833333, position_offset=1.0159,
            files=["figlib-"]),
    ]
    return cfg


class _Runs:
    """Each (package, route, figures) run once, on first request: its PNGs
    keyed by path below the output directory, and its tables by name."""

    def __init__(self, library_dir, tmp_root):
        self.library_dir, self.tmp_root, self.done = library_dir, tmp_root, {}

    def __call__(self, package, route, figures=True):
        key = (package, route, figures)
        if key not in self.done:
            out = self.tmp_root / f"{package}-{route}-{int(figures)}"
            jax = package == "jax"
            cfg = _source(self.library_dir, out, jax, figures)
            mod = jax_pipeline if jax else port_pipeline
            dev = {} if jax else {"device": "cpu"}
            if route == "library":
                outs = mod.process_video_source_library(cfg, verbose=False, **dev)
            else:
                outs = mod.process_video_source(cfg, backend=route,
                                                verbose=False, **dev)
            assert len(outs) == 2
            pngs = {str(p.relative_to(out)): p.read_bytes()
                    for p in sorted(out.rglob("*.png"))}
            tables = {p.name: p.read_bytes() for p in sorted(out.glob("*.txt"))}
            self.done[key] = (pngs, tables)
        return self.done[key]


@pytest.fixture(scope="module")
def runs(fig_library, tmp_path_factory):
    return _Runs(fig_library, tmp_path_factory.mktemp("fig-runs"))


def _assert_same(got, want):
    """Equal PNG sets, byte-equal PNGs (named on a mismatch), equal tables."""
    (got_pngs, got_tables), (want_pngs, want_tables) = got, want
    assert sorted(got_pngs) == sorted(want_pngs)
    for rel in got_pngs:
        assert got_pngs[rel] == want_pngs[rel], rel
    assert got_tables and got_tables == want_tables


def test_library_figures_match_per_file_bytes(runs):
    lib = runs("port", "library")
    pngs = lib[0]
    assert pngs, "library mode wrote no figures"
    # Per-frame compact figures AND stacked sequences, per video.
    assert any("stacked-sequence" in n for n in pngs)
    assert any("Frame" in n for n in pngs)
    _assert_same(lib, runs("port", "gpu"))
    _assert_same(lib, runs("jax", "library"))
    _assert_same(runs("port", "gpu"), runs("jax", "tpu"))


def test_device_backend_figures_match_gpu_bytes(runs):
    """``backend="device"`` has no per-frame hook on the device scan, so a
    host-scan replay collects its figures: byte-equal to ``gpu``'s."""
    dev = runs("port", "device")
    assert dev[0], "backend='device' wrote no figures"
    assert any("Frame" in n for n in dev[0])  # per-frame diagnostics
    _assert_same(dev, runs("port", "gpu"))
    _assert_same(dev, runs("jax", "device"))


def test_library_figures_off_writes_no_pngs(runs):
    pngs, tables = runs("port", "library", figures=False)
    assert not pngs
    assert tables  # tables still written
    assert (pngs, tables) == runs("jax", "library", figures=False)
