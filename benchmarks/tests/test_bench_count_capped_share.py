"""The reader of ``staging.count_capped_share`` on hand-made records: the
share of the counted frames whose count stopped early, None where the
program keeps no such counter (as an older program does not)."""

import json

import pytest

from conftest import BENCH
from harness.cell import load_reader

READ = load_reader("staging.count_capped_share")


@pytest.mark.parametrize("stages, share", [
    ({"count.frames_counted": 16384, "count.frames_count_capped": 16384}, 1.0),
    ({"count.frames_counted": 16384, "count.frames_count_capped": 16301}, 16301 / 16384),
    ({"count.frames_counted": 8192, "count.frames_count_capped": 0}, 0.0),
])
def test_share_of_the_counted_frames(stages, share):
    record = {"stages": dict(stages, read_gather=0.08), "window_s": 0.5}
    assert READ(record) == pytest.approx(share, rel=1e-12)


@pytest.mark.parametrize("record", [
    {},
    {"window_s": 0.5},
    {"stages": {"read_gather": 0.08, "count.frames_counted": 8192,
                "count.frames_counted_vector": 8192}},
    {"stages": {"count.frames_counted": 0, "count.frames_count_capped": 0}},
], ids=["empty", "no_stages", "no_capped_counter", "nothing_counted"])
def test_without_its_counters_returns_none(record):
    assert READ(record) is None


def test_listed_for_the_library_cells():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    metric = next(m for m in spec["per_layer"]
                  if m["name"] == "staging.count_capped_share")
    assert metric["workloads"] == ["nova.library", "nova_ranks4.library"]
    assert metric["moves"] == "frames_per_s"
