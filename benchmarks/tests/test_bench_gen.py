"""The frozen generator against the program's writer, and the recipe."""

import json
import re

import numpy as np
import pytest

from conftest import BENCH
from gen import plan_library, write_recording_plan


def _load(kind, name):
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def test_bytes_equal_the_programs_writer(tmp_path):
    from hsip_tpu_torch.io import synthetic as program

    from gen import synthetic as frozen

    spec = dict(x0=20.0, v0_px=3.0, ddt_frame=14, v_jump_px=9.0,
                ignition_frame=3, seed=1234)
    for mod, where in ((program, tmp_path / "p"), (frozen, tmp_path / "f")):
        frames, _ = mod.synthesize_flame_video(24, height=32, width=128,
                                               flame=mod.FlameSpec(**spec))
        mod.write_recording(where, "run-1-001", frames, spec=mod.CihxSpec(
            width=128, height=32, total_frames=24, bit_depth=12))
    for suffix in (".cihx", ".mraw"):
        assert (tmp_path / "p" / f"run-1-001{suffix}").read_bytes() == \
            (tmp_path / "f" / f"run-1-001{suffix}").read_bytes()


@pytest.mark.parametrize("traffic,config", [
    ("library_8x2048", "nova"), ("per_file_8x2048", "nova")])
def test_every_seed_draws_the_same_sizes(traffic, config):
    t, c = _load("traffic", traffic), _load("configs", config)
    shapes = set()
    for seed in (0, 7, 2**31 + 11, 2**40 + 3):
        plans = plan_library(t, c, seed)
        assert len(plans) == t["recordings"]
        assert sum(p.has_ddt for p in plans) == round(t["ddt_share"] * t["recordings"])
        for p in plans:
            lo, hi = t["ignition_frame"]
            assert lo <= p.flame["ignition_frame"] <= hi
            if p.has_ddt:
                assert p.flame["ddt_frame"] < p.frames
        shapes.add(tuple((p.frames, p.height, p.width) for p in plans))
    assert len(shapes) == 1
    assert plan_library(t, c, 5) == plan_library(t, c, 5)
    assert plan_library(t, c, 5) != plan_library(t, c, 6)


@pytest.mark.parametrize("traffic,config", [
    ("library_8x2048", "nova"), ("per_file_8x2048", "nova")])
def test_names_meet_every_calibration_entry(traffic, config):
    """Every calibration entry matches a recording and every recording
    matches an entry, by the program's own matching rule."""
    from hsip_tpu_torch.track.config import FileCalibration

    c = _load("configs", config)
    entries = [FileCalibration(**e) for e in c["source"]["file_calibrations"]]
    names = [p.name for p in plan_library(_load("traffic", traffic), c, 1)]
    assert all(any(e.matches(n) for e in entries) for n in names)
    assert all(any(e.matches(n) for n in names) for e in entries)
    for n in names:
        assert re.fullmatch(r"[A-Za-z0-9_-]+", n)


def test_recordings_are_distinct(tmp_path):
    t, c = _load("traffic", "library_8x2048"), _load("configs", "nova")
    plans = plan_library(t, c, 99, frames=16, recordings=3)
    blobs = set()
    for p in plans:
        meta = write_recording_plan(str(tmp_path / "x"), p)
        blobs.add(np.fromfile(meta.replace(".cihx", ".mraw"), np.uint8).tobytes())
    assert len(blobs) == 3
