"""Profiling: wall-clock stage attribution (``StageTimes``, a copy of the
JAX package's) and :func:`profile_trace`, a ``torch.profiler`` trace of a
scope. The JAX package's on-demand profiler server has no counterpart."""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

__all__ = ["StageTimes", "profile_trace"]


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
