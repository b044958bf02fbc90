"""Profiling: wall-clock stage attribution (copy of ``StageTimes`` from
:mod:`hsip_tpu.utils.profiling`; its profiler trace and server are not
copied)."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

__all__ = ["StageTimes"]


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

