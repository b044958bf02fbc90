"""The four-rank route (``routes/library_ranks4.py``) on the CPU: a traced
rehearsal of ``nova_ranks4.library`` that prints its readings and leaves
no process behind, a record that holds every rank's stages, a rank that
fails at start-up and one that fails in a call, each ending the run with
an error in time, a rank that takes recordings round robin did not give
it, which the check sees, the ranks' device events put on rank 0's clock,
and the readers of the ranks' span and counter."""

import importlib
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import time

import pytest

from conftest import BENCH
from harness import runner
from harness.cell import load_cell, load_reader, load_route

CELL = "nova_ranks4.library"
NEW = ["parallel.rank_ms_per_rec", "parallel.rank_wait_ms_per_call"]


def _real_rank_main():
    return importlib.import_module("routes.library_ranks4").rank_main


def rank_fails_at_start(rank, coordinator, device_type, conn):
    """Rank 2 ends before it reports; the others run as they would."""
    if rank == 2:
        raise SystemExit(3)
    _real_rank_main()(rank, coordinator, device_type, conn)


def rank_fails_in_a_call(rank, coordinator, device_type, conn):
    """Rank 2's library call raises from its second pass on (the first is
    the warm pass)."""
    if rank == 2:
        import hsip_tpu_torch.pipeline as pipeline

        original, passes = pipeline.process_video_source_library, []

        def failing(*args, **kwargs):
            passes.append(1)
            if len(passes) > 1:
                raise RuntimeError("rank 2 made to fail in a call")
            return original(*args, **kwargs)

        pipeline.process_video_source_library = failing
    _real_rank_main()(rank, coordinator, device_type, conn)


def test_ranks_are_the_configurations():
    route = load_route(load_cell(CELL).traffic["route"])
    assert route.RANKS == load_cell(CELL).config["deployment"]["ranks"] == 4
    # The harness's span is the tracking function, as in nova.library.
    assert route.TRACKING == load_route("library").TRACKING


def test_traced_rehearsal_reads_the_ranks_and_leaves_no_process():
    proc = subprocess.Popen(
        [sys.executable, "benchmarks/run.py", "--workload", CELL,
         "--seed", "4294967311", "--seconds", "2", "--trace", "1", "--rehearse"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=BENCH.parent, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    for name in NEW:
        assert line["metrics"][name]["value"] > 0 and line["metrics"][name]["unit"] == "ms"
    assert "ranks 1-3 joined the record" in err
    assert "(no clock range) of ranks []" in err
    # The ranks' own output went to stderr: stdout is the line alone.
    assert len(out.strip().splitlines()) == 1
    assert err.count("Running distributed: 4 processes") >= 2
    # Nothing of the run's session outlives it (ranks, pools, trackers).
    deadline = time.monotonic() + 30
    while True:
        try:
            os.killpg(proc.pid, 0)
        except ProcessLookupError:
            break
        assert time.monotonic() < deadline, "a process of the run is still alive"
        time.sleep(0.2)


@pytest.mark.parametrize("entry, limit_s, match", [
    (rank_fails_at_start, "START_TIMEOUT_S", r"rank 2 ended \(exit code 3\)"),
    (rank_fails_in_a_call, "CALL_TIMEOUT_S",
     "call 0: rank 2 failed: RuntimeError: rank 2 made to fail in a call"),
])
def test_a_failing_rank_ends_the_run_in_time(monkeypatch, entry, limit_s, match):
    import torch.distributed as dist

    route = load_route(load_cell(CELL).traffic["route"])
    monkeypatch.setattr(route, "_rank_entry", lambda: entry)
    monkeypatch.setattr(runner, "load_route", lambda name: route)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        runner.measure(CELL, 2147483647, 2.0, False, rehearse=True)
    # Set-up on the CPU takes well under a minute; the wait is the route's.
    assert time.monotonic() - t0 < getattr(route, limit_s) + 60
    assert multiprocessing.active_children() == []
    assert not dist.is_initialized()


def _records(monkeypatch):
    """The records the harness hands its readers, as they come."""
    records, real = [], runner.load_reader

    def spy(name):
        read = real(name)

        def reading(record):
            records.append(record)
            return read(record)
        return reading

    monkeypatch.setattr(runner, "load_reader", spy)
    return records


def test_the_record_holds_every_rank(monkeypatch):
    records = _records(monkeypatch)
    line = runner.measure(CELL, 3000000019, 2.0, True, rehearse=True)
    assert line["correct"] is True
    record = records[0]
    stages, calls = record["stages"], record["calls"]
    # Round robin gives ranks 0-2 one rehearsal recording each, rank 3
    # none; every rank's stages joined rank 0's.
    assert stages["count.rank_recordings"] == runner.REHEARSAL_RECORDINGS * len(calls)
    assert stages["count.frames_counted"] == sum(c["frames"] for c in calls)
    assert stages["bench.rank_pass"] > record["tracking_s"]
    assert multiprocessing.active_children() == []


def _takes_everything(self, total_count, distribution="round_robin"):
    return list(range(total_count))


def test_a_rank_that_takes_anothers_recordings_is_not_correct(monkeypatch):
    # Rank 0 (this process) tracks every recording besides the ranks that
    # round robin gives them: those are tracked twice, and count missing.
    from hsip_tpu_torch.parallel.processor import VideoProcessor

    monkeypatch.setattr(VideoProcessor, "distribute_indices", _takes_everything)
    line = runner.measure(CELL, 2718281828, 2.0, False, rehearse=True)
    assert line["correct"] is False
    calls = line["attempted"] // runner.REHEARSAL_RECORDINGS
    # Recordings 1 and 2 (ranks 1 and 2) were tracked twice in every call.
    assert line["checks"]["answers_missing"]["value"] == 2 * calls


def _summary(out, rank, names):
    name = "run-summary.json" if rank == 0 else f"run-summary.rank{rank}.json"
    (out / name).write_text(json.dumps({"files": [{"file": n} for n in names]}))


@pytest.mark.parametrize("summaries, wrong", [
    ({0: ["a.cihx", "e.cihx"], 1: ["b.cihx"], 2: ["c.cihx"], 3: ["d.cihx"]}, []),
    ({0: ["a.cihx", "b.cihx", "e.cihx"], 1: ["b.cihx"], 2: ["c.cihx"],
      3: ["d.cihx"]}, [2]),                       # twice
    ({0: ["a.cihx", "e.cihx"], 1: ["c.cihx"], 2: ["b.cihx"], 3: ["d.cihx"]},
     [2, 3]),                                     # the wrong rank
    ({0: ["a.cihx"], 1: ["b.cihx"], 2: ["c.cihx"], 3: ["d.cihx"]}, [0]),  # by none
])
def test_misplaced_recordings(tmp_path, summaries, wrong):
    route = load_route(load_cell(CELL).traffic["route"])
    paths = [str(tmp_path / "src" / f"{n}.cihx") for n in "eabcd"]
    for rank, names in summaries.items():
        _summary(tmp_path, rank, names)
    # In path order a, b, c, d, e go to ranks 0, 1, 2, 3, 0.
    assert route.round_robin(paths) == {1: 0, 2: 1, 3: 2, 4: 3, 0: 0}
    assert route.misplaced(tmp_path, paths) == sorted(wrong)


def test_the_ranks_device_events_join_on_rank_0s_clock():
    import torch

    from hsip_tpu_torch.utils.profiling import StageTimes

    route = load_route(load_cell(CELL).traffic["route"])
    clock = {"ph": "X", "cat": "user_annotation", "name": route.CLOCK}

    class Tracer:
        stage_times, band_launches = StageTimes(), [(2, 3, 4)]

        def start(self):
            pass

        def stop(self, path):
            # Rank 0's trace clock runs 500 us ahead of the wall clock.
            return [dict(clock, ts=1500.0, dur=1.0),
                    {"ph": "X", "cat": "kernel", "name": "k", "ts": 1600.0, "dur": 5.0}]

    class Ranks:
        device, stages = torch.device("cpu"), StageTimes()

        def ask(self, request, what, seconds):
            if what == "tracing":
                return {1: None}
            # Rank 1's kernel ran 700 us after the wall clock's 1000.
            return {1: {"stages": {"read_gather": 0.25, "count.rank_recordings": 2},
                        "band_launches": [[5, 6, 7]], "memory_peak_bytes": 0,
                        "events": [{"ph": "X", "cat": "kernel", "name": "k",
                                    "ts": 1700.0, "dur": 5.0}]}}

    tracer, ranks = Tracer(), Ranks()
    route._join_the_trace(tracer, ranks)
    tracer.start()
    ranks.wall_us = 1000.0  # as _mark_clock gave it
    ranks.stages.add("read_gather", 0.5)
    events = tracer.stop("unused")
    assert [e["ts"] for e in events if e.get("cat") == "kernel"] == [1600.0, 2200.0]
    assert tracer.stage_times.as_dict(ndigits=9) == {
        "read_gather": 0.75, "count.rank_recordings": 2}
    assert tracer.band_launches == [(2, 3, 4), (5, 6, 7)]


CALLS = [{"wall_s": 0.30, "frames": 4096, "recordings": 8},
         {"wall_s": 0.20, "frames": 4096, "recordings": 8}]


def test_readers_of_the_ranks():
    record = {"calls": CALLS, "window_s": 0.5, "tracking_s": 0.4,
              "stages": {"rank_wait": 0.05, "bench.rank_pass": 1.6,
                         "count.rank_recordings": 16}}
    assert load_reader("parallel.rank_wait_ms_per_call")(record) == \
        pytest.approx(0.05 / 2 * 1e3, rel=1e-12)
    assert load_reader("parallel.rank_ms_per_rec")(record) == \
        pytest.approx((1.6 - 0.05) / 16 * 1e3, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_readers_without_the_ranks_return_none(name):
    # A program without the span and the counter, as the parent's, or a
    # run without a processor.
    record = {"calls": CALLS, "window_s": 0.5, "tracking_s": 0.4,
              "stages": {"read_gather": 0.1, "bench.rank_pass": 1.6}}
    assert load_reader(name)(record) is None
    assert load_reader(name)({}) is None
