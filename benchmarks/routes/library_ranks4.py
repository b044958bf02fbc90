"""Four ``--distributed`` ranks share one card over a library, as a lab
runs the reference's ``mpiexec -n 4`` on one GPU workstation. Every rank
is ``hsip-torch`` (``hsip_tpu_torch.cli.main``) with README's manual
launch::

    --config <toml> --distributed --coordinator 127.0.0.1:<port>
    --num-processes 4 --process-id r --library --no-images --no-sequences
    --quiet

(and ``--device cpu`` in a CPU rehearsal); round robin gives each rank its
share of the source's recordings, and each rank writes its own tables.

Rank 0 is the harness's process; ranks 1-3 are started once, in ``warm``,
after rank 0 has run the source alone (so that the kernels and the native
codec are built once), and kept for the whole window. A call is one pass
of every rank over the source into the call's directory; the ranks'
standard output goes to stderr, so that the harness's line stays the last
of its stdout. After the pass the ranks' run summaries must list every
recording once, under the rank round robin gives it; the tables of a
recording that breaks this are taken out of the call's directory, so that
the check counts it missing.

Every rank hands its library driver a ``StageTimes`` of its own and adds
the driver's wall to it as ``bench.rank_pass``. In a traced run each of
ranks 1-3 runs the harness's ``Tracer`` of its own over the window, and
when the harness stops its trace the ranks send their stages, band
launches and device events; they join the harness's record, the events
moved onto rank 0's clock, so the device readings are the card's and the
stage readings every rank's. ``tracking_s`` stays rank 0's.

The route forms the process group itself, with a 60 s timeout, so that
``cli.main``'s own ``initialize_distributed`` finds it up: a rank that
dies in a call ends the run within 60 s. Before any collective of the
program each rank makes a tensor on ``VideoProcessor.local_device`` and
reports over its pipe; a rank that fails or does not answer at start-up
ends the run within 120 s. The ranks stop when the harness drops ``ctx``
(a ``weakref.finalize`` on the handle that only ``ctx`` holds;
``SimpleNamespace`` takes no weak reference), when a call fails, and at
exit at the latest (the finalizer's own ``atexit``, and daemon
processes).
"""

import contextlib
import dataclasses
import importlib
import json
import multiprocessing
import os
import socket
import sys
import tempfile
import time
import traceback
import weakref
from multiprocessing.connection import wait
from pathlib import Path

TRACKING = ("hsip_tpu_torch.track.batch", "track_collection_device")
RANKS = 4
START_TIMEOUT_S = 120.0
CALL_TIMEOUT_S = 60.0
TRACE_TIMEOUT_S = 300.0  # a rank's trace of the window: stop, export, read
PASS = "bench.rank_pass"
CLOCK = "bench.rank_clock"


def _toml(value):
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return json.dumps(value)
    return "[" + ", ".join(_toml(v) for v in value) + "]"


def _write_config(ctx, out_dir):
    """The run's TOML, as a user writes it (``examples/run.toml``), with
    the call's output directory."""
    src = ctx.source
    keys = dict(name=src.name, enabled=True, video_path=src.video_path,
                output_dir=str(out_dir), calibration=src.calibration,
                position_offset=src.position_offset,
                detection_method=src.detection_method,
                use_frame_diff=src.use_frame_diff,
                use_absolute_time=src.use_absolute_time,
                skip_frames=list(src.skip_frames))
    if src.trigger_frame is not None:
        keys["trigger_frame"] = src.trigger_frame
    lines = ["[[source]]"] + [f"{k} = {_toml(v)}" for k, v in keys.items()]
    for cal in src.file_calibrations:
        lines += ["", "[[source.file_calibration]]"]
        lines += [f"{k} = {_toml(v)}" for k, v in dataclasses.asdict(cal).items()]
    lines += ["", "[detector]"]
    lines += [f"{k} = {_toml(v)}" for k, v in dataclasses.asdict(ctx.detector).items()]
    path = out_dir.with_name(out_dir.name + ".toml")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def _argv(config, device_type, coordinator=None, rank=None):
    argv = ["--config", str(config), "--library", "--no-images",
            "--no-sequences", "--quiet"]
    if coordinator is not None:
        argv += ["--distributed", "--coordinator", coordinator,
                 "--num-processes", str(RANKS), "--process-id", str(rank)]
    return argv + (["--device", "cpu"] if device_type == "cpu" else [])


def _run_pass(argv, stages):
    """``cli.main`` over ``argv`` with its standard output on stderr; the
    library driver gets ``stages`` and its wall is added as ``PASS``."""
    import hsip_tpu_torch.pipeline as pipeline
    from hsip_tpu_torch.cli import main

    driver = pipeline.process_video_source_library

    def timed(*args, **kwargs):
        kwargs["stage_times"] = stages
        t0 = time.perf_counter()
        try:
            return driver(*args, **kwargs)
        finally:
            stages.add(PASS, time.perf_counter() - t0)

    pipeline.process_video_source_library = timed
    try:
        with contextlib.redirect_stdout(sys.stderr):
            return main(argv)
    finally:
        pipeline.process_video_source_library = driver


def _stage_times():
    from hsip_tpu_torch.utils.profiling import StageTimes

    return StageTimes()


def _merge(into, stages):
    """Add one rank's ``StageTimes.as_dict()`` into ``into``."""
    for name, value in stages.items():
        if name.startswith("count."):
            into.count(name[len("count."):], value)
        else:
            into.add(name, value)


def _mark_clock():
    """Open the range ``CLOCK`` now: the wall clock in microseconds at
    which it opened (see ``_clock_offset``)."""
    import torch

    wall_us = time.time_ns() / 1e3
    with torch.profiler.record_function(CLOCK):
        pass
    return wall_us


def _clock_offset(events, wall_us):
    """The trace's clock less the wall clock, in microseconds, from the
    ``CLOCK`` range opened at ``wall_us``; None when the trace lacks it."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == CLOCK:
            return float(e["ts"]) - wall_us
    return None


def _device_events(events, offset):
    """The trace's kernels, copies and fills, on the wall clock."""
    from harness.trace import DEVICE_CATEGORIES

    return [dict(e, ts=float(e["ts"]) - offset) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def _memory_peak(device):
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


class _RankTrace:
    """A rank's share of a traced run: the harness's ``Tracer`` in this
    process (the profiler, and the band kernel's launches) and the
    stages its passes give."""

    def __init__(self):
        self.stages = _stage_times()
        self.tracer = None
        self.wall_us = None

    def start(self):
        from harness.trace import Tracer

        self.stages = _stage_times()
        self.tracer = Tracer(TRACKING)
        self.tracer.start()
        self.wall_us = _mark_clock()

    def stop(self, device):
        fd, path = tempfile.mkstemp(prefix="hsip-rank-", suffix=".json")
        os.close(fd)
        try:
            events = self.tracer.stop(Path(path))
        finally:
            self.tracer.uninstall()
            with contextlib.suppress(FileNotFoundError):
                os.unlink(path)
        offset = _clock_offset(events, self.wall_us)
        launches, self.tracer = list(self.tracer.band_launches), None
        return {"stages": self.stages.as_dict(ndigits=12),
                "band_launches": launches,
                "events": None if offset is None else _device_events(events, offset),
                "memory_peak_bytes": _memory_peak(device)}


def _threads(device):
    """What a rank computes on and with how many threads: torch's intra-op
    pool and the native codec's OpenMP floor."""
    import torch

    from hsip_tpu_torch._native import native_decoder

    return {"device": str(device), "torch_threads": torch.get_num_threads(),
            "native_threads": native_decoder().num_threads}


def rank_main(rank, coordinator, device_type, conn):
    """Ranks 1-3: join the group, make a tensor on the rank's device, then
    serve rank 0's requests (``("pass", argv)``, ``("trace", on)``) until
    it sends None or its end of the pipe closes."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        import torch

        from hsip_tpu_torch.parallel import VideoProcessor, initialize_distributed

        conn.send(("started", rank))
        initialize_distributed(coordinator_address=coordinator,
                               num_processes=RANKS, process_id=rank,
                               timeout_s=CALL_TIMEOUT_S)
        device = VideoProcessor().local_device(device_type)
        torch.zeros(1, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        conn.send(("ready", _threads(device)))
        trace = _RankTrace()
        while True:
            try:
                request = conn.recv()
            except EOFError:
                return
            if request is None:
                return
            kind, arg = request
            if kind == "pass":
                conn.send(("done", _run_pass(arg, trace.stages)))
            elif arg:
                trace.start()
                conn.send(("tracing", None))
            else:
                conn.send(("traced", trace.stop(device)))
    except BaseException:
        with contextlib.suppress(OSError):
            conn.send(("failed", traceback.format_exc()))
        raise


def _rank_entry():
    """``rank_main`` under a name that a spawned process can import (the
    harness loads this file under a name of its own)."""
    return importlib.import_module("routes.library_ranks4").rank_main


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs, conns):
    """Ask every rank to end, wait a little, then kill what is left."""
    for conn in conns.values():
        with contextlib.suppress(OSError, ValueError):
            conn.send(None)
    deadline = time.monotonic() + 10.0
    for proc in procs.values():
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs.values():
        if proc.is_alive():
            proc.kill()
            proc.join(10.0)
    for conn in conns.values():
        conn.close()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class _Ranks:
    """Ranks 1-3 as spawned processes of this one, with their pipes, and
    rank 0's stages."""

    def __init__(self, device):
        mp = multiprocessing.get_context("spawn")
        self.device = device
        self.stages = _stage_times()
        self.wall_us = None  # when rank 0's trace opened ``CLOCK``
        self.coordinator = f"127.0.0.1:{_free_port()}"
        self.procs, self.conns = {}, {}
        self.stop = weakref.finalize(self, _stop, self.procs, self.conns)
        entry = _rank_entry()
        for rank in range(1, RANKS):
            ours, theirs = mp.Pipe()
            proc = mp.Process(target=entry, name=f"hsip-rank{rank}", daemon=True,
                              args=(rank, self.coordinator, device.type, theirs))
            proc.start()
            theirs.close()
            self.procs[rank], self.conns[rank] = proc, ours

    def ask(self, request, what, seconds):
        """Send ``request`` to every rank and wait for its ``what``."""
        for conn in self.conns.values():
            conn.send(request)
        return self.expect(what, time.monotonic() + seconds)

    def expect(self, what, deadline):
        """Each rank's next message, which must be ``what``: its payload by
        rank. Raises when a rank sends another, ends, or has not answered
        by ``deadline`` (``time.monotonic``)."""
        pending, got = dict(self.conns), {}
        while pending:
            ready = wait(list(pending.values())
                         + [self.procs[r].sentinel for r in pending],
                         timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                raise RuntimeError(f"rank(s) {sorted(pending)} sent no {what!r} "
                                   f"in time")
            for rank in list(pending):
                conn, proc = pending[rank], self.procs[rank]
                if conn.poll():
                    try:
                        kind, payload = conn.recv()
                    except EOFError:
                        proc.join(5.0)  # its exit code, when it has one
                        raise RuntimeError(
                            f"rank {rank} ended (exit code {proc.exitcode}) "
                            f"before {what!r}") from None
                    if kind != what:
                        raise RuntimeError(f"rank {rank} sent {kind!r} before "
                                           f"{what!r}:\n{payload}")
                    got[rank] = payload
                    del pending[rank]
                elif not proc.is_alive():
                    raise RuntimeError(f"rank {rank} ended (exit code "
                                       f"{proc.exitcode}) before {what!r}")
        return got

    def failures(self):
        """The last line of each failure a rank has reported, by rank,
        without waiting."""
        found = {}
        for rank, conn in self.conns.items():
            with contextlib.suppress(EOFError, OSError):
                while conn.poll():
                    kind, payload = conn.recv()
                    if kind == "failed":
                        found[rank] = payload.strip().splitlines()[-1]
        return found


def _harness_tracer():
    """The harness's ``Tracer`` in a traced run, else None: the wrapper it
    puts on ``TRACKING`` holds it."""
    from harness.trace import Tracer

    wrapper = getattr(importlib.import_module(TRACKING[0]), TRACKING[1])
    for cell in getattr(wrapper, "__closure__", None) or ():
        with contextlib.suppress(ValueError):
            if isinstance(cell.cell_contents, Tracer):
                return cell.cell_contents
    return None


def _join_the_trace(tracer, ranks):
    """Have the ranks trace the window with the harness, and their
    readings join its record when it stops."""
    start, stop, ref = tracer.start, tracer.stop, weakref.ref(ranks)

    def start_all():
        ranks = ref()
        start()
        ranks.wall_us = _mark_clock()
        ranks.stages = _stage_times()
        ranks.ask(("trace", True), "tracing", START_TIMEOUT_S)

    def stop_all(path):
        ranks = ref()
        events = stop(path)
        traced = ranks.ask(("trace", False), "traced", TRACE_TIMEOUT_S)
        _merge(tracer.stage_times, ranks.stages.as_dict(ndigits=12))
        offset = _clock_offset(events, ranks.wall_us)
        peaks, joined, unclocked = {0: _memory_peak(ranks.device)}, 0, []
        for rank, got in sorted(traced.items()):
            _merge(tracer.stage_times, got["stages"])
            tracer.band_launches.extend(tuple(s) for s in got["band_launches"])
            peaks[rank] = got["memory_peak_bytes"]
            if offset is None or got["events"] is None:
                unclocked.append(rank)
                continue
            events.extend(dict(e, ts=e["ts"] + offset) for e in got["events"])
            joined += len(got["events"])
        print(f"ranks 1-{RANKS - 1} joined the record: their stages, band "
              f"launches and {joined} device events; device events left out "
              f"(no clock range) of ranks {unclocked if offset is not None else 'all'}"
              f"; memory peaks (bytes) {peaks}", file=sys.stderr)
        return events

    tracer.start, tracer.stop = start_all, stop_all


def _start(ctx):
    from hsip_tpu_torch.parallel import initialize_distributed

    # Every rank runs on this host and talks over the loopback, which gloo
    # then need not find by the host's name (the machine may have no other).
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ranks = _Ranks(ctx.device)
    try:
        deadline = time.monotonic() + START_TIMEOUT_S
        ranks.expect("started", deadline)
        initialize_distributed(coordinator_address=ranks.coordinator,
                               num_processes=RANKS, process_id=0,
                               timeout_s=CALL_TIMEOUT_S)
        ready = ranks.expect("ready", deadline)
    except BaseException:
        ranks.stop()
        raise
    print(f"ranks ready on a host of {os.cpu_count()} cores: "
          f"{dict(sorted({0: _threads(ctx.device), **ready}.items()))}",
          file=sys.stderr)
    return ranks


def round_robin(paths):
    """The rank round robin gives each recording: its place among the
    source's recordings in path order, modulo the ranks."""
    order = sorted(range(len(paths)), key=lambda k: Path(paths[k]))
    return {k: place % RANKS for place, k in enumerate(order)}


def misplaced(out_dir, paths):
    """The recordings that the ranks' run summaries in ``out_dir`` do not
    list exactly once, under the rank round robin gives them."""
    listed = {}
    for rank in range(RANKS):
        name = "run-summary.json" if rank == 0 else f"run-summary.rank{rank}.json"
        with contextlib.suppress(FileNotFoundError):
            for entry in json.loads((out_dir / name).read_text())["files"]:
                listed.setdefault(entry["file"], []).append(rank)
    owner = round_robin(paths)
    return [k for k in range(len(paths))
            if listed.get(Path(paths[k]).name) != [owner[k]]]


def _take_out(out_dir, paths, ks):
    from reference import TABLE_KINDS, table_suffix

    for k in ks:
        for kind in TABLE_KINDS:
            with contextlib.suppress(FileNotFoundError):
                (out_dir / f"{Path(paths[k]).stem}{table_suffix(kind)}").unlink()


def call(ctx, index, out_dir):
    ranks = ctx.ranks
    try:
        config = _write_config(ctx, out_dir)
        for rank, conn in ranks.conns.items():
            conn.send(("pass", _argv(config, ranks.device.type, ranks.coordinator,
                                     rank)))
        rc = _run_pass(_argv(config, ranks.device.type, ranks.coordinator, 0),
                       ranks.stages)
        done = ranks.expect("done", time.monotonic() + CALL_TIMEOUT_S)
        if rc or any(done.values()):
            raise RuntimeError(f"a rank's pass failed: rank 0 returned {rc}, "
                               f"the others {done}")
    except BaseException as exc:
        # Rank 0 fails in a collective when another rank has gone; name
        # the rank that went, and why.
        failed = ranks.failures()
        ranks.stop()
        if failed and isinstance(exc, Exception):
            raise RuntimeError(f"call {index}: " + "; ".join(
                f"rank {r} failed: {why}" for r, why in sorted(failed.items()))
            ) from exc
        raise
    wrong = misplaced(out_dir, ctx.paths)
    if wrong:
        print(f"call {index}: recordings {wrong} not tracked once by their "
              f"round-robin rank; their tables are taken out", file=sys.stderr)
        _take_out(out_dir, ctx.paths, wrong)
    return list(range(len(ctx.paths)))


def warm(ctx, out_dir):
    rc = _run_pass(_argv(_write_config(ctx, out_dir / "alone"), ctx.device.type),
                   _stage_times())
    if rc:
        raise RuntimeError(f"rank 0 alone returned {rc}")
    ctx.ranks = _start(ctx)
    tracer = _harness_tracer()
    if tracer is not None:
        _join_the_trace(tracer, ctx.ranks)
    call(ctx, 0, out_dir / "ranks")
