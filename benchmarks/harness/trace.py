"""The traced run: spans around the program's calls, ``StageTimes`` handed
to its stages, ``torch.profiler`` over the window, and the arithmetic that
turns the trace into busy time, kernel times and idle gaps.

The interval arithmetic is copied from the program's
``hsip_tpu_torch/utils/profiling.py`` (``summarize_device_events``) so
that the yardstick does not move when the program changes.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Tracer", "DEVICE_CATEGORIES", "device_intervals", "merge",
           "summarize_trace"]

# Chrome-trace categories of work on the card: kernels, copies, fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
NAME_CHARS = 160  # device operations are named by this much of their name
CALL = "bench.call"
TRACKING = "bench.tracking"


def _record_function(name: str):
    import torch

    return torch.profiler.record_function(name)


def stage_times_class():
    """The program's ``StageTimes`` with each stage also opened as a
    profiler range, so that idle gaps can be named by the stage the host
    was in."""
    from hsip_tpu_torch.utils.profiling import StageTimes

    class TracedStageTimes(StageTimes):
        @contextlib.contextmanager
        def stage(self, name):
            with _record_function(f"stage.{name}"):
                with super().stage(name):
                    yield

    return TracedStageTimes


class Tracer:
    """Instrumentation of one traced run, installed from the harness.

    Wraps the route's tracking function (a span a call, a ``stage_times``
    handed in where the caller passed none) and the band kernel's launcher
    (the shape of each launch, for its byte count)."""

    def __init__(self, tracking: Tuple[str, str]):
        self.stage_times = stage_times_class()()
        self.tracking_s = 0.0
        self.band_launches: List[Tuple[int, int, int]] = []
        self._patches = []
        self._install(tracking)
        self._install_band()
        self._prof = None

    def _patch(self, module: str, attr: str, make):
        mod = importlib.import_module(module)
        original = getattr(mod, attr)
        wrapper = make(original)
        setattr(mod, attr, wrapper)
        self._patches.append((mod, attr, original, wrapper))

    def _install(self, tracking):
        def make(original):
            def tracked(*args, **kwargs):
                if kwargs.get("stage_times") is None:
                    kwargs["stage_times"] = self.stage_times
                t0 = time.perf_counter()
                try:
                    with _record_function(TRACKING):
                        return original(*args, **kwargs)
                finally:
                    self.tracking_s += time.perf_counter() - t0
            return tracked
        self._patch(tracking[0], tracking[1], make)

    def _install_band(self):
        def make(original):
            def launcher(band, *args, **kwargs):
                self.band_launches.append(tuple(int(s) for s in band.shape))
                return original(band, *args, **kwargs)
            # The launcher counts its launches on the module attribute.
            launcher.launches = getattr(original, "launches", 0)
            return launcher
        self._patch("hsip_tpu_torch.kernels.cuda_preprocess",
                    "cuda_band_profiles", make)

    def reset(self):
        """Forget what set-up recorded."""
        self.stage_times = stage_times_class()()
        self.tracking_s = 0.0
        self.band_launches = []

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop(self, path: Path) -> List[dict]:
        self._prof.stop()
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
        Path(path).unlink()
        return events

    def uninstall(self):
        for mod, attr, original, wrapper in reversed(self._patches):
            if hasattr(original, "launches"):
                original.launches = wrapper.launches
            setattr(mod, attr, original)
        self._patches = []


def window_marker():
    return _record_function(WINDOW)


def call_marker():
    return _record_function(CALL)


def device_intervals(events: List[dict]) -> np.ndarray:
    """(start, end) in microseconds of every kernel, copy and fill."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    return np.array(sorted(spans), dtype=np.float64).reshape(-1, 2)


def merge(spans: np.ndarray) -> np.ndarray:
    """The union of sorted intervals as disjoint sorted intervals
    (overlapping streams count once)."""
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.float64).reshape(-1, 2)


def _annotations(events, prefix=("bench.", "stage.")):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(prefix)]


def summarize_trace(events: List[dict], top: int = 10) -> Optional[dict]:
    """Busy time, device time by operation and idle gaps by host activity
    inside the window range; None when the trace holds no device event or
    no window range."""
    ann = _annotations(events)
    windows = [(s, e) for s, e, n in ann if n == WINDOW]
    spans = device_intervals(events)
    if not windows or spans.size == 0:
        return None
    w0, w1 = windows[0]
    spans = np.clip(spans, w0, w1)
    spans = spans[spans[:, 1] > spans[:, 0]]
    busy = merge(spans)
    if busy.size == 0:
        return None
    by_op: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            ts = float(e["ts"])
            if w0 <= ts <= w1:
                name = str(e.get("name", "?"))[:NAME_CHARS]
                acc = by_op.setdefault(name, [0.0, 0])
                acc[0] += float(e.get("dur", 0.0)) * 1e-6
                acc[1] += 1
    # Idle gaps: between busy intervals, and before the first / after the
    # last. Each piece of a gap is named by the innermost harness span or
    # program stage that holds it (the shortest range that holds it).
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    inner = [(s, e, n) for s, e, n in ann if n != WINDOW]
    points = np.unique(np.concatenate(
        [gaps.ravel()] + [np.array([s, e]) for s, e, _ in inner]))
    points = points[(points >= w0) & (points <= w1)]
    lo, hi = points[:-1], points[1:]
    mids = (lo + hi) / 2
    at = np.searchsorted(gaps[:, 0], mids, side="right") - 1
    idle_piece = (at >= 0) & (mids < gaps[np.maximum(at, 0), 1])
    label = np.full(mids.size, "harness (between calls)", dtype=object)
    best = np.full(mids.size, np.inf)
    for s, e, name in inner:
        hit = (mids >= s) & (mids <= e) & (e - s < best)
        label[hit] = name
        best[hit] = e - s
    idle: Dict[str, float] = {}
    for lab, length in zip(label[idle_piece], (hi - lo)[idle_piece]):
        idle[lab] = idle.get(lab, 0.0) + float(length) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6,
        "trace_window_s": (w1 - w0) * 1e-6,
        "device_ops": {name: {"seconds": acc[0], "launches": acc[1]}
                       for name, acc in ops},
        "breakdown": {
            "device_ops": [[name, acc[0]] for name, acc in ops[:top]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:top],
        },
    }
