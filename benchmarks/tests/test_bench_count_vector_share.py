"""The reader of ``staging.count_vector_share`` on hand-made records: the
share of the counted frames a vector path covered, None where the program
keeps no such counters (as an older program does not)."""

import pytest

from conftest import BENCH  # noqa: F401  (puts benchmarks/ on the path)
from harness.cell import load_reader

READ = load_reader("staging.count_vector_share")


@pytest.mark.parametrize("stages, share", [
    ({"count.frames_counted": 8192, "count.frames_counted_vector": 8192}, 1.0),
    ({"count.frames_counted": 8192, "count.frames_counted_vector": 6144}, 0.75),
    ({"count.frames_counted": 8192, "count.frames_counted_vector": 0}, 0.0),
])
def test_share_of_the_counted_frames(stages, share):
    record = {"stages": dict(stages, read_gather=0.08), "window_s": 0.5}
    assert READ(record) == pytest.approx(share, rel=1e-12)


@pytest.mark.parametrize("record", [
    {},
    {"window_s": 0.5},
    {"stages": {"read_gather": 0.08, "count.frames_staged": 8192}},
    {"stages": {"count.frames_counted": 0, "count.frames_counted_vector": 0}},
], ids=["empty", "no_stages", "no_counters", "nothing_counted"])
def test_without_its_counters_returns_none(record):
    assert READ(record) is None
