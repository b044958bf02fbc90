"""Profiling: wall-clock stage attribution (``StageTimes``, a copy of the
JAX package's), :func:`profile_trace`, a ``torch.profiler`` trace of a
scope, :func:`device_time`, the card's busy time and idle share over one
run read from such a trace, and the helpers the measurement scripts share:
:func:`sync`, :func:`launched_by` and :func:`device_info`. The JAX
package's on-demand profiler server has no counterpart."""

from __future__ import annotations

import contextlib
import json
import platform
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

__all__ = ["StageTimes", "device_info", "device_time", "kernel_launches", "launched_by",
           "profile_trace", "summarize_device_events", "sync"]

# Chrome-trace categories of work on the card: kernels, copies, fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class StageTimes:
    """Thread-safe accumulating wall-clock attribution for pipeline stages.

    The map phase free-runs (dispatch without blocking), so a stage's
    accumulated time is the HOST wall-clock spent inside it — device work
    hidden behind host work shows up in whichever stage finally blocks
    (conventionally ``drain``/``scan``). Stages are additive per thread but
    CONCURRENT threads (e.g. the library map pool) can overlap, so the sum
    of stages may exceed end-to-end wall-clock; each stage remains a true
    measure of where that work's time went.
    """

    def __init__(self) -> None:
        self._t: Dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._t[name] = self._t.get(name, 0.0) + seconds

    def wrap(self, name: str, fn):
        """A callable timing each invocation of ``fn`` under ``name``."""

        def timed(*args, **kwargs):
            with self.stage(name):
                return fn(*args, **kwargs)

        return timed

    def as_dict(self, ndigits: int = 4) -> Dict[str, float]:
        with self._lock:
            return {k: round(v, ndigits) for k, v in sorted(self._t.items())}


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device=None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the scope into ``log_dir``.

    No-op when ``log_dir`` is None, so call sites can thread a CLI flag
    straight through. Otherwise the scope runs under
    ``torch.profiler.profile`` over the CPU activity, and the CUDA activity
    when ``device`` (a ``torch.device``, or its name) is a CUDA device, and
    on leaving the scope one Chrome trace, ``hsip-trace-<pid>.json``, is
    written into ``log_dir`` (created if missing); open it in
    ``chrome://tracing`` or Perfetto. The file name carries the process id
    so the ranks of a multi-process run can share a directory. A trace
    holds every operator and kernel launch of the scope: keep profiled runs
    short.
    """
    if log_dir is None:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"hsip-trace-{os.getpid()}.json"))


def summarize_device_events(events: List[dict], wall_s: float, top: int = 5) -> dict:
    """The card's time in a Chrome trace's ``traceEvents`` over a run of
    ``wall_s`` host seconds.

    ``device_busy_s`` is the length of the union of the intervals of every
    kernel, copy and fill (streams that overlap count once);
    ``idle_share`` is ``1 - device_busy_s / wall_s``; ``top_kernels`` the
    ``top`` kernels by summed device time (name, ms, launches). Raises
    ``RuntimeError`` when the trace holds no device event: a trace without
    the card says nothing of its idle share.
    """
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
    )
    if not spans:
        raise RuntimeError(
            "the trace holds no device events (kernels, copies or fills); "
            "the run did not reach a CUDA device, so no idle share is measured"
        )
    busy_us = 0.0
    start, end = spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy_us += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy_us += end - start
    by_name: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            acc = by_name.setdefault(e.get("name", "?"), [0.0, 0])
            acc[0] += float(e.get("dur", 0.0))
            acc[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    busy_s = busy_us * 1e-6
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall_s,
        "device_events": len(spans),
        "top_kernels": [{"name": name, "ms": acc[0] * 1e-3, "launches": acc[1]}
                        for name, acc in ranked],
    }


def device_time(fn, device, top: int = 5) -> dict:
    """Run ``fn()`` once under :func:`profile_trace` (CPU and, on a CUDA
    ``device``, CUDA activities), the host clock around it ending in
    ``torch.cuda.synchronize()``, and summarize the card's time over that
    run with :func:`summarize_device_events`. Raises ``RuntimeError`` when
    the trace holds no device events (always so on a CPU device)."""
    import torch

    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="hsip-trace-") as tmp:
        with profile_trace(tmp, dev):
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall_s = time.perf_counter() - t0
        (path,) = Path(tmp).glob("hsip-trace-*.json")
        events = json.loads(path.read_text()).get("traceEvents", [])
    return summarize_device_events(events, wall_s, top)


def sync(device) -> None:
    """Wait for the card: a host clock stopped without it measures the
    enqueue. Nothing to wait for on the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_launches():
    """(band kernel, scan kernel) launch counts of this process so far."""
    from ..kernels.cuda_preprocess import cuda_band_profiles
    from ..track.cuda_scan import cuda_tracking_scan

    return cuda_band_profiles.launches, cuda_tracking_scan.launches


def launched_by(fn):
    """``(fn(), [band, scan] launches fn made)``."""
    before = kernel_launches()
    out = fn()
    return out, [a - b for a, b in zip(kernel_launches(), before)]


def device_info(device) -> dict:
    """What a measurement ran on: ``platform`` 'gpu' or 'cpu', the card's
    name, the card count and the card's power limit in watts
    (``nvidia-smi --query-gpu=name,power.limit``; None when it cannot be
    read)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": platform.machine(), "count": 1}
    index = device.index if device.index is not None else torch.cuda.current_device()
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
            "count": torch.cuda.device_count(), "power_limit_w": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
        print(f"nvidia-smi: {smi[index]}", file=sys.stderr)
        info["power_limit_w"] = float(smi[index].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as exc:
        print(f"no power limit from nvidia-smi ({exc})", file=sys.stderr)
    return info
