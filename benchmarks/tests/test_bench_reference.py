"""The NumPy reference against the program's ``device`` and ``exact``
tables, on the CPU at small sizes: recordings with and without DDT,
with late ignition and short records, under the ``nova`` configuration
with each of the reference's two detectors (``combined``, its own, and
``threshold``)."""

import json
from pathlib import Path

import pytest

from conftest import BENCH
from gen import RecordingPlan, write_recording_plan
from reference import TABLE_KINDS, read_cihx, reference_tables, table_suffix

FLAME = {"background_level": 40, "background_noise": 6, "flame_level": 3000,
         "edge_width_px": 2.0, "accel_px": 0.0, "x0": 30.0}
CASES = {
    # name: frames, flame
    "run-1-001": (160, dict(v0_px=0.45, ignition_frame=4, seed=11)),
    "run-2-002": (160, dict(v0_px=0.5, ignition_frame=9, ddt_frame=70,
                            v_jump_px=24.0, seed=12)),
    "x-003-run-3": (192, dict(v0_px=0.35, ignition_frame=120, seed=13)),
    "x-004-run-10": (192, dict(v0_px=0.55, ignition_frame=110, ddt_frame=150,
                               v_jump_px=21.0, seed=14)),
    "run-1-005": (24, dict(v0_px=4.0, ignition_frame=2, seed=15)),
    "run-2-006": (40, dict(v0_px=0.3, ignition_frame=39, seed=16)),
}


def _config(name, detection_method=None):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    if detection_method is not None:
        config["source"]["detection_method"] = detection_method
    return config


def _program_tables(meta, config, backend, out):
    from hsip_tpu_torch.pipeline import process_video_file
    from hsip_tpu_torch.track.config import (FileCalibration, FlameDetectorConfig,
                                             VideoSourceConfig)

    src = dict(config["source"])
    cals = [FileCalibration(**c) for c in src.pop("file_calibrations")]
    cfg = VideoSourceConfig(**src, file_calibrations=cals,
                            save_frame_images=False, save_stacked_sequences=False)
    cfg.output_dir = str(out)
    process_video_file(meta, cfg, FlameDetectorConfig(**config["detector"]),
                       backend=backend, verbose=False, save_images=False,
                       device="cpu")
    stem = Path(meta).stem
    found = {}
    for kind in TABLE_KINDS:
        f = Path(out) / f"{stem}{table_suffix(kind)}"
        if f.exists():
            found[kind] = f.read_text()
    return found


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    root = tmp_path_factory.mktemp("rec")
    plans = [RecordingPlan(name=n, frames=f, height=48, width=256, bit_depth=12,
                           record_rate=100000, flame={**FLAME, **fl})
             for n, (f, fl) in CASES.items()]
    return [write_recording_plan(str(root), p) for p in plans]


@pytest.mark.parametrize("method", ["combined", "threshold"])
@pytest.mark.parametrize("backend", ["device", "exact"])
def test_reference_equals_the_programs_tables(recordings, method, backend,
                                              tmp_path):
    cfg = _config("nova", method)
    post = 0
    for meta in recordings:
        expect = reference_tables(meta, cfg["source"], cfg["detector"])
        assert _program_tables(meta, cfg, backend, tmp_path / backend) == expect, meta
        post += "post_ddt" in expect
    if method == "combined":
        assert post >= 1  # the DDT split is exercised


def test_cihx_fields(recordings):
    meta = read_cihx(recordings[0])
    assert (meta["width"], meta["height"], meta["frames"]) == (256, 48, 160)
    assert (meta["record_rate"], meta["start_frame"], meta["skip_frame"],
            meta["storage_bits"]) == (100000, 0, 1, 12)


def test_bfloat16_control_differs(recordings):
    """The control (the band chain in bfloat16) writes other rows."""
    from harness.check import rows_of

    cfg = _config("nova")
    off = 0
    for meta in recordings:
        a = reference_tables(meta, cfg["source"], cfg["detector"])
        b = reference_tables(meta, cfg["source"], cfg["detector"],
                             precision="bfloat16")
        off += sum(x != y for x, y in zip(rows_of(a.get("all")), rows_of(b.get("all"))))
    assert off > 0

