"""Each metric reader on a hand-made record, and the trace arithmetic on
a hand-made trace. A reader that finds nothing to read returns None."""

import json

import pytest

from conftest import BENCH
from harness.cell import load_reader
from harness.counts import H100_HBM_BYTES_PER_S, band_profiles_bytes
from harness.trace import summarize_trace

CALLS = [{"wall_s": 0.30, "frames": 4096, "recordings": 2},
         {"wall_s": 0.20, "frames": 4096, "recordings": 2}]
RECORD = {
    "setup_s": 12.5, "window_s": 0.5, "calls": CALLS,
    "stages": {"read_gather": 0.08, "tables": 0.004}, "tracking_s": 0.4,
    "band_launches": [(4096, 19, 1024), (2048, 19, 1024)],
    "device_ops": {"void band_profiles_kernel<3, 13>(BandArgs)":
                   {"seconds": 0.001, "launches": 2},
                   "void tracking_scan_kernel<8, 0>(ScanArgs)":
                   {"seconds": 0.002, "launches": 2},
                   "Memcpy HtoD (Pinned -> Device)": {"seconds": 0.01, "launches": 9}},
    "busy_s": 0.05,
}
EXPECT = {
    "setup_s": 12.5,
    "frames_per_s": 8192 / 0.5,
    "pipeline.self_ms_per_rec": (0.5 - 0.4) / 4 * 1e3,
    "staging.read_gather_ms_per_rec": 0.08 / 4 * 1e3,
    "track.tables_ms_per_rec": 0.004 / 4 * 1e3,
    "kernel.band_profiles_roofline_pct":
        100 * (band_profiles_bytes(4096, 19, 1024) + band_profiles_bytes(2048, 19, 1024))
        / H100_HBM_BYTES_PER_S / 0.001,
    "kernel.tracking_scan_us_per_frame": 0.002 / 8192 * 1e6,
    "device.idle_share": 1 - 0.05 / 0.5,
}


def _metric_names():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    return [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]


def test_every_metric_has_a_reader():
    for name in _metric_names():
        assert callable(load_reader(name))


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_arithmetic(name):
    assert load_reader(name)(RECORD) == pytest.approx(EXPECT[name], rel=1e-12)


def test_band_bytes_match_the_published_bound():
    # 0.0551 ms at N=2048, B=19, W=1024 (the kernel table's bound)
    assert band_profiles_bytes(2048, 19, 1024) / H100_HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(0.0551, abs=5e-5)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_without_its_source_returns_none(name):
    assert load_reader(name)({}) is None
    if name not in ("setup_s", "frames_per_s"):
        assert load_reader(name)({"calls": CALLS, "window_s": 0.5}) is None


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_union_ops_and_idle_gaps():
    events = [
        _x("bench.window", "user_annotation", 0, 100),
        _x("bench.call", "user_annotation", 0, 60),
        _x("bench.tracking", "user_annotation", 10, 40),
        _x("stage.read_gather", "user_annotation", 10, 20),
        _x("k1", "kernel", 30, 10),
        _x("k2", "kernel", 35, 10),          # overlaps k1: counted once
        _x("Memcpy HtoD", "gpu_memcpy", 70, 5),
        _x("k3", "kernel", 150, 10),         # after the window
        _x("aten::add", "cpu_op", 0, 100),   # not a device event
    ]
    s = summarize_trace(events)
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["trace_window_s"] == pytest.approx(100e-6)
    assert s["device_ops"]["k1"]["seconds"] == pytest.approx(10e-6)
    assert "k3" not in s["device_ops"]
    idle = dict(s["breakdown"]["idle_gaps"])
    # 0-10 call, 10-30 read_gather, 45-50 tracking, 50-60 call,
    # 60-70 and 75-100 between calls
    assert idle["bench.call"] == pytest.approx(20e-6)
    assert idle["stage.read_gather"] == pytest.approx(20e-6)
    assert idle["bench.tracking"] == pytest.approx(5e-6)
    assert idle["harness (between calls)"] == pytest.approx(35e-6)
    assert sum(idle.values()) == pytest.approx(100e-6 - s["busy_s"])


def test_trace_without_device_events_is_none():
    assert summarize_trace([_x("bench.window", "user_annotation", 0, 100)]) is None
    assert summarize_trace([_x("k1", "kernel", 30, 10)]) is None
