"""One run of one cell: set-up, the measured window, the check, the line.

Set-up (``setup_s``, from the process's start to the window's) imports
torch and the program, starts the card, synthesizes the cell's recordings
from the seed in worker processes (``fsync``ed, under the run's
``TMPDIR``) and makes one warm pass of the cell's route, which builds or
loads every kernel and touches every shape the window uses.

The window calls the route's user entry in a closed loop until
``--seconds`` have passed; the call in flight at the deadline completes
and counts, so the window ends with the last completed call. Each call
writes its tables into a directory of its own; after the window every
one of them is compared with the plain reference (:mod:`harness.check`).
"""

from __future__ import annotations

import contextlib
import gc
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

from .cell import load_cell, load_reader, load_route

__all__ = ["measure", "run_cell", "NoCard", "ForbiddenModules",
           "REHEARSAL_FRAMES", "REHEARSAL_RECORDINGS"]

# A rehearsal shrinks the cell so that the CPU can run it.
REHEARSAL_FRAMES = 96
REHEARSAL_RECORDINGS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "hsip_tpu")


class NoCard(RuntimeError):
    """The machine has no CUDA card, or fewer than the cell asks for."""


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""


def forbidden_modules(modules=None):
    """Top-level names among ``modules`` (default ``sys.modules``) that
    are JAX's or the JAX package's, compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _pool(workers: int):
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _source_config(config: dict, video_path: str):
    from hsip_tpu_torch.track.config import FileCalibration, VideoSourceConfig

    src = dict(config["source"])
    cals = [FileCalibration(**c) for c in src.pop("file_calibrations", [])]
    cfg = VideoSourceConfig(**src, enabled=True, file_calibrations=cals,
                            save_frame_images=False, save_stacked_sequences=False)
    cfg.video_path = video_path
    return cfg


def _power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
        _log(f"nvidia-smi: {out[0]}")
        return float(out[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as exc:
        _log(f"no power limit from nvidia-smi ({exc})")
        return None


def measure(workload: str, seed: int, seconds: float, trace: bool,
            rehearse: bool = False, t0: Optional[float] = None) -> dict:
    """Run the cell once; the result line as a dict (``checks`` last)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(workload)
    import torch

    if rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(
                f"{workload} needs {cell.chips} CUDA card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    import hsip_tpu_torch  # noqa: F401  (fails here without the program)
    from hsip_tpu_torch.track.config import FlameDetectorConfig

    from gen import plan_library, write_library

    from .check import (checks_of, compare_calls, is_correct,
                        read_table_file, reference_for)
    from .trace import Tracer, call_marker, summarize_trace, window_marker

    route = load_route(cell.traffic["route"])
    sizes = {}
    if rehearse:
        sizes = dict(frames=min(int(cell.traffic["frames"]), REHEARSAL_FRAMES),
                     recordings=min(int(cell.traffic["recordings"]),
                                    REHEARSAL_RECORDINGS))
    plans = plan_library(cell.traffic, cell.config, seed, **sizes)
    workers = 2 if rehearse else max(1, min(8, os.cpu_count() or 1))
    workdir = Path(tempfile.mkdtemp(prefix="hsip-bench-"))
    tracer = None
    try:
        with _pool(workers) as pool:
            pending = write_library(str(workdir / "recordings"), plans, pool,
                                    wait=False)
            if device.type == "cuda":
                torch.zeros(1, device=device)  # the card's context, meanwhile
            paths = [f.result() for f in pending]
        ctx = SimpleNamespace(
            paths=paths,
            source=_source_config(cell.config, str(workdir / "recordings")),
            detector=FlameDetectorConfig(**cell.config["detector"]),
            device=device,
        )
        if trace:
            tracer = Tracer(route.TRACKING)
        route.warm(ctx, workdir / "warm")
        _sync(device)
        if tracer is not None:
            tracer.reset()
            tracer.start()
        setup_s = time.perf_counter() - t0

        frames = [p.frames for p in plans]
        calls = []
        marker = window_marker() if tracer is not None else contextlib.nullcontext()
        with marker:
            start = time.perf_counter()
            deadline = start + seconds
            index = 0
            while not calls or time.perf_counter() < deadline:
                out_dir = workdir / "out" / f"{index:06d}"
                span = call_marker() if tracer is not None else contextlib.nullcontext()
                with span:
                    c0 = time.perf_counter()
                    done = route.call(ctx, index, out_dir)
                    _sync(device)
                    c1 = time.perf_counter()
                calls.append({"index": index, "out_dir": out_dir,
                              "recordings": done, "wall_s": c1 - c0, "end": c1})
                index += 1
        window_s = calls[-1]["end"] - start
        record = {"setup_s": setup_s, "window_s": window_s}
        summary = None
        if tracer is not None:
            events = tracer.stop(workdir / "trace.json")
            summary = summarize_trace(events)
            record.update(
                stages=tracer.stage_times.as_dict(ndigits=9),
                tracking_s=tracer.tracking_s,
                band_launches=list(tracer.band_launches),
            )
            if summary is not None:
                record.update(busy_s=summary["busy_s"],
                              device_ops=summary["device_ops"])
            tracer.uninstall()
            tracer = None
        if device.type == "cuda":
            memory_peak = int(torch.cuda.max_memory_allocated(device))
            info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                    "count": cell.chips, "memory_peak_bytes": memory_peak,
                    "power_limit_w": _power_limit_w()}
        else:
            info = {"platform": "cpu", "kind": "cpu (rehearsal, not a measurement)",
                    "count": 1, "memory_peak_bytes": 0}
        if trace:
            info["window_s"] = window_s
            info["busy_s"] = record.get("busy_s", 0.0)
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(f"loaded in the measuring process: {found}")

        # The program's state goes before the reference runs.
        del ctx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        c0 = time.perf_counter()
        with _pool(workers) as pool:
            expected = reference_for(paths, cell.config["source"],
                                     cell.config["detector"], pool)
        verdict = compare_calls(calls, paths, expected, read_table_file)
        # Frames count only where the call delivered the recording's tables.
        for call, done in zip(calls, verdict["delivered"]):
            call["frames"] = sum(frames[k] for k in done)
        record["calls"] = [{"wall_s": c["wall_s"], "frames": c["frames"],
                            "recordings": len(c["recordings"])} for c in calls]
        _log(f"reference: {len(paths)} recordings in "
             f"{time.perf_counter() - c0:.3f} s; {verdict['answers']} answers "
             f"compared over {len(calls)} calls, {verdict['answers_missing']} "
             f"missing")
        if verdict["first_wrong"]:
            _log(f"first wrong answers (call, recording, rows off): "
                 f"{verdict['first_wrong']}")

        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        walls = sorted(c["wall_s"] for c in calls)
        slowest = sorted(calls, key=lambda c: -c["wall_s"])[:3]
        _log(f"window: {len(calls)} calls, {sum(c['frames'] for c in calls)} "
             f"frames, {window_s:.6f} s; setup {setup_s:.3f} s; call walls "
             f"n={len(walls)} min {walls[0]:.6f} median "
             f"{walls[len(walls) // 2]:.6f} max {walls[-1]:.6f} s; slowest "
             + ", ".join(f"#{c['index']} {c['wall_s']:.6f}" for c in slowest))

        limits = cell.config["limits"]
        result = {
            "correct": is_correct(verdict, limits),
            "attempted": verdict["answers"],
            "failed": verdict["answers_missing"] + verdict["answers_wrong"],
            "metrics": metrics,
            "device": info,
        }
        if trace and summary is not None:
            result["breakdown"] = summary["breakdown"]
        result["checks"] = checks_of(verdict, limits)
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(f"loaded in the measuring process: {found}")
        return result
    finally:
        if tracer is not None:
            tracer.uninstall()
        shutil.rmtree(workdir, ignore_errors=True)


def run_cell(workload, seed, seconds, trace, rehearse=False, t0=None) -> int:
    """Measure and print; the process's exit code."""
    try:
        result = measure(workload, seed, seconds, trace, rehearse=rehearse, t0=t0)
    except NoCard as exc:
        _log(f"no measurement: {exc}")
        return 2
    except ModuleNotFoundError as exc:
        _log(f"no measurement: the program cannot be imported ({exc})")
        return 3
    except ForbiddenModules as exc:
        _log(f"no measurement: {exc}")
        return 4
    _log(f"correct = {result['correct']}")
    for name, c in result["checks"].items():
        _log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
