"""The port's spans and counters (``StageTimes``) on the CPU.

``StageTimes`` opens a ``stage.<name>`` profiler range only while a
profiler records, and keeps counters that ``as_dict`` returns as
``count.<name>``. The source runners time their own host work (discovery,
the ledger, open, frame 0's background, the table writer) and hand the
caller's ``stage_times`` to the tracking function as given, None
included: a wrapper that fills in a ``stage_times`` where the caller gave
none (as a traced benchmark run does) then still reaches the tracking
function. The library program times its main thread's wait for the
gathers, its group metadata and its staging buffer, and counts the frames
staged and copied and the groups clipped. The fused gather+count pass, on
either route, counts the frames it counted and those a vector path did.
"""

import importlib
import json
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import hsip_tpu_torch.pipeline as port_pipeline  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.track.config import VideoSourceConfig  # noqa: E402
from hsip_tpu_torch.utils import StageTimes  # noqa: E402

FRAMES = 48
_LIBRARY = (
    ("nova-run-1-001", FlameSpec(x0=30.0, v0_px=8.0, ignition_frame=2, seed=3)),
    ("nova-run-1-002", FlameSpec(x0=22.0, v0_px=5.0, ddt_frame=25,
                                 v_jump_px=24.0, ignition_frame=3, seed=5)),
)


@pytest.fixture(scope="module")
def library_dir(tmp_path_factory):
    """Two 48-frame 12-bit recordings of one shape."""
    d = tmp_path_factory.mktemp("tracing") / "library"
    for stem, flame in _LIBRARY:
        frames, _ = synthesize_flame_video(FRAMES, height=48, width=512,
                                           flame=flame)
        write_recording(d, stem, frames,
                        spec=CihxSpec(width=512, height=48, total_frames=FRAMES,
                                      record_rate=100_000, bit_depth=12))
    return d


def _source(library_dir, out):
    cfg = VideoSourceConfig(name="Lib", enabled=True, save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.video_path = str(library_dir)
    cfg.output_dir = str(out)
    return cfg


def _run(runner, library_dir, out, stage_times=None):
    """One call of a source runner on the CPU; its outputs."""
    cfg = _source(library_dir, out)
    if runner == "file":
        cihx = sorted(library_dir.glob("*.cihx"))[0]
        return [port_pipeline.process_video_file(
            cihx, cfg, backend="device", verbose=False, device="cpu",
            stage_times=stage_times)]
    if runner == "source":
        return port_pipeline.process_video_source(
            cfg, backend="device", verbose=False, device="cpu",
            stage_times=stage_times)
    return port_pipeline.process_video_source_library(
        cfg, verbose=False, device="cpu", stage_times=stage_times)


def _trace_events(tmp_path, fn):
    """``fn()`` under the CPU profiler; the exported Chrome trace's events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _stage_ranges(events):
    """{range name: set of thread ids} of the ``stage.*`` ranges."""
    out = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and name.startswith("stage."):
            out.setdefault(name, set()).add(e.get("tid"))
    return out


# ---- StageTimes ----

def test_counters_round_trip_through_as_dict():
    t = StageTimes()
    t.add("h2d", 0.25)
    t.count("frames_staged", 2048)
    t.count("frames_staged", 1024)
    t.count("clipped_groups")
    t.count("clipped_groups", 0)
    assert t.as_dict() == {"h2d": 0.25, "count.clipped_groups": 1,
                           "count.frames_staged": 3072}
    assert t.as_dict(ndigits=9)["count.frames_staged"] == 3072
    assert StageTimes().as_dict() == {}


def test_counters_lose_no_update_across_threads():
    t = StageTimes()
    workers, bumps = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [t.count("n") for _ in range(bumps)])
                   for _ in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t.as_dict()["count.n"] == workers * bumps


def test_stage_opens_a_range_only_under_a_profiler(tmp_path, monkeypatch):
    opened = []
    original = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return original(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    t = StageTimes()
    with t.stage("x"):
        pass
    assert t.wrap("y", lambda a: a + 1)(1) == 2
    assert opened == []

    def staged():
        with t.stage("x"):
            with t.stage("inner"):
                pass

    events = _trace_events(tmp_path, staged)
    assert opened == ["stage.x", "stage.inner"]
    ranges = _stage_ranges(events)
    assert ranges["stage.x"] == ranges["stage.inner"] == {threading.get_native_id()}
    with t.stage("x"):
        pass
    assert len(opened) == 2  # the profiler has stopped
    assert set(t.as_dict()) == {"x", "y", "inner"}


# ---- the runners hand their caller's stage_times down ----

_TRACKING = {"file": ("hsip_tpu_torch.pipeline", "track_video"),
             "source": ("hsip_tpu_torch.pipeline", "track_video"),
             "library": ("hsip_tpu_torch.track.batch", "track_collection_device")}


@pytest.mark.parametrize("given", [False, True], ids=["none", "given"])
@pytest.mark.parametrize("runner", sorted(_TRACKING))
def test_runner_hands_its_stage_times_to_tracking(library_dir, tmp_path,
                                                  monkeypatch, runner, given):
    """The tracking function sees the caller's argument as a keyword, and a
    wrapper that fills in its own where it finds None is obeyed."""
    module, attr = _TRACKING[runner]
    mod = importlib.import_module(module)
    original = getattr(mod, attr)
    seen, filled = [], StageTimes()

    def tracked(*args, **kwargs):
        seen.append(kwargs.get("stage_times", "missing"))
        if kwargs.get("stage_times") is None:
            kwargs["stage_times"] = filled
        return original(*args, **kwargs)

    monkeypatch.setattr(mod, attr, tracked)
    mine = StageTimes() if given else None
    outs = _run(runner, library_dir, tmp_path / "out", stage_times=mine)
    assert outs and all(o.rows for o in outs)
    assert seen and all(s is mine for s in seen), seen
    got = (mine if given else filled).as_dict()
    assert "read_gather" in got and "tables" in got, got
    if given:
        assert filled.as_dict() == {}


# ---- what each runner and the library program record ----

def test_library_call_records_its_stages_and_counters(library_dir, tmp_path):
    t = StageTimes()
    outs = _run("library", library_dir, tmp_path / "out", stage_times=t)
    assert len(outs) == len(_LIBRARY) and all(o.rows for o in outs)
    got = t.as_dict()
    for key in ("discover", "ledger", "open", "pool_take", "read_gather",
                "gather_wait", "group_meta", "h2d", "device_dispatch", "d2h",
                "tables", "write_tables"):
        assert key in got, got
    assert "background" not in got  # the library gathers frame 0's max
    assert got["count.frames_staged"] == len(_LIBRARY) * FRAMES
    assert got["count.frames_copied"] == got["count.frames_staged"]
    assert got["count.clipped_groups"] == 0


@pytest.mark.parametrize("runner", ["file", "source"])
def test_per_file_call_records_its_stages(library_dir, tmp_path, runner):
    t = StageTimes()
    outs = _run(runner, library_dir, tmp_path / "out", stage_times=t)
    assert outs and all(o.rows for o in outs)
    got = t.as_dict()
    for key in ("open", "background", "read_gather", "h2d", "pin_copy",
                "device_dispatch", "tables", "write_tables"):
        assert key in got, got
    assert ("discover" in got) == ("ledger" in got) == (runner == "source")
    # no group program: the fused gather+count pass's counters alone
    assert {k for k in got if k.startswith("count.")} == {
        "count.frames_counted", "count.frames_counted_vector"}


@pytest.mark.parametrize("runner", ["file", "library"])
def test_fused_pass_counts_its_frames_and_the_vector_ones(library_dir, tmp_path,
                                                          runner):
    """Every frame staged went through the fused gather+count pass; the
    vector path covered all of them or none, as the build reports."""
    from hsip_tpu_torch._native import native_decoder

    t = StageTimes()
    outs = _run(runner, library_dir, tmp_path / "out", stage_times=t)
    assert outs and all(o.rows for o in outs)
    got = t.as_dict()
    staged = FRAMES * len(outs)
    assert got["count.frames_counted"] == staged
    vector = native_decoder().count_path != "scalar"
    assert got["count.frames_counted_vector"] == (staged if vector else 0)


@pytest.mark.parametrize("runner, names", [
    ("library", ("discover", "ledger", "open", "pool_take", "gather_wait",
                 "group_meta", "write_tables")),
    ("file", ("open", "background", "h2d", "pin_copy", "write_tables")),
], ids=["library", "file"])
def test_stages_reach_the_trace_on_the_main_thread(library_dir, tmp_path,
                                                   runner, names):
    """With no stage_times given, the runners' and the program's stages
    still open their ranges, on the calling thread."""
    events = _trace_events(
        tmp_path, lambda: _run(runner, library_dir, tmp_path / "out"))
    ranges = _stage_ranges(events)
    main = threading.get_native_id()
    for name in names:
        assert main in ranges.get(f"stage.{name}", ()), (name, ranges)
