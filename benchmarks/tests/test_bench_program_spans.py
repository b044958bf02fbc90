"""The readers of the program's own spans and counters, and a traced CPU
rehearsal of each cell that prints them.

A reader finds its number in the ``StageTimes`` that the traced run hands
to the tracking function (the record's ``stages``); where the program has
no such stage or counter, as an older program has not, it returns None
and the line leaves the metric out."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH
from harness.cell import load_reader

CALLS = [{"wall_s": 0.30, "frames": 4096, "recordings": 2},
         {"wall_s": 0.20, "frames": 4096, "recordings": 2}]
STAGES = {"read_gather": 0.08, "tables": 0.004, "gather_wait": 0.06,
          "group_meta": 0.012, "pin_copy": 0.02,
          "count.frames_staged": 8192, "count.frames_copied": 6144,
          "count.clipped_groups": 1}
EXPECT = {
    "staging.gather_wait_ms_per_rec": ("gather_wait", 0.06 / 4 * 1e3),
    "fused.group_meta_ms_per_rec": ("group_meta", 0.012 / 4 * 1e3),
    "staging.pin_copy_ms_per_rec": ("pin_copy", 0.02 / 4 * 1e3),
    "clip.frames_copied_share": ("count.frames_copied", 6144 / 8192),
}
# The metrics each cell's traced line carries on the CPU (no device
# trace there): the program's stages and counters and the harness span.
SPANS = {
    "nova.library": ["pipeline.self_ms_per_rec", "staging.read_gather_ms_per_rec",
                     "track.tables_ms_per_rec", "staging.gather_wait_ms_per_rec",
                     "fused.group_meta_ms_per_rec", "clip.frames_copied_share"],
    "nova.per_file": ["pipeline.self_ms_per_rec", "staging.read_gather_ms_per_rec",
                      "track.tables_ms_per_rec", "staging.pin_copy_ms_per_rec"],
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_reads_its_stage(name):
    record = {"calls": CALLS, "window_s": 0.5, "stages": dict(STAGES)}
    assert load_reader(name)(record) == pytest.approx(EXPECT[name][1], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_without_its_key_returns_none(name):
    key = EXPECT[name][0]
    stages = {k: v for k, v in STAGES.items() if k != key}
    assert load_reader(name)({"calls": CALLS, "window_s": 0.5,
                              "stages": stages}) is None
    assert load_reader(name)({"calls": CALLS, "window_s": 0.5}) is None
    assert load_reader(name)({}) is None


def test_share_without_frames_staged_returns_none():
    stages = {"count.frames_copied": 0, "count.frames_staged": 0}
    assert load_reader("clip.frames_copied_share")({"stages": stages}) is None


def test_each_new_metric_names_the_cells_that_read_it():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in EXPECT:
        cells = per_layer[name]["workloads"]
        assert [c for c in SPANS if name in SPANS[c]] == cells


@pytest.mark.parametrize("workload", sorted(SPANS))
def test_traced_rehearsal_prints_the_program_spans(workload):
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", workload,
         "--seed", "2147483647", "--seconds", "2", "--trace", "1", "--rehearse"],
        capture_output=True, text=True, timeout=600, cwd=BENCH.parent, check=True,
    ).stdout.strip().splitlines()[-1]
    line = json.loads(out)
    assert line["correct"] is True
    assert sorted(line["metrics"]) == sorted(SPANS[workload])
    if workload == "nova.library":
        # ignition at frames 2-20 keeps every group above the clip's rule
        assert line["metrics"]["clip.frames_copied_share"]["value"] == 1.0
