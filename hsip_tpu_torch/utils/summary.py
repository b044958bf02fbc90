"""Machine-readable per-run summaries.

Each pipeline run writes ``run-summary.json`` next to its result tables: the
per-file outcomes (rows, DDT, truncation, empty counts, timing) plus the
effective configuration — the reference offered only scrollback prints.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["RunSummary"]


class RunSummary:
    """Accumulates per-file outcomes for one source run, then writes JSON."""

    def __init__(self, source_name: str, config_echo: Optional[Dict[str, Any]] = None):
        self.source_name = source_name
        self.config_echo = config_echo or {}
        self.files: List[Dict[str, Any]] = []
        self.failures: List[Dict[str, str]] = []
        #: True once THIS run recorded an outcome (seeding doesn't count) —
        #: the write gate, so an all-skipped --resume never rewrites.
        self.dirty = False
        self._t0 = time.time()

    def add_failure(self, filename: str, error: BaseException) -> None:
        """Record a recording that could not be processed (skipped)."""
        self._drop(filename)
        self.dirty = True
        self.failures.append(
            {"file": filename, "error": f"{type(error).__name__}: {error}"}
        )

    def seed_from(self, output_dir, rank: int = 0) -> None:
        """Load a previous run's summary so a ``--resume`` run accumulates
        onto it instead of clobbering it with only the retried files.
        Entries re-processed this run replace their previous record."""
        name = "run-summary.json" if rank == 0 else f"run-summary.rank{rank}.json"
        path = Path(output_dir) / name
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError):
            return
        self.files = [f for f in data.get("files", []) if isinstance(f, dict)]
        self.failures = [
            f for f in data.get("failures", []) if isinstance(f, dict)
        ]

    def _drop(self, filename: str) -> None:
        self.files = [f for f in self.files if f.get("file") != filename]
        self.failures = [f for f in self.failures if f.get("file") != filename]

    def add_file(
        self,
        filename: str,
        output,
        calibration: float,
        position_offset: float,
        wall_s: float,
        n_frames: int,
    ) -> None:
        """Record one processed recording's outcome (a TrackingOutput)."""
        self._drop(filename)
        self.dirty = True
        tracker = output.tracker
        self.files.append(
            {
                "file": filename,
                "n_frames": n_frames,
                "rows": len(output.rows),
                "empty_frames": output.empty_frame_count,
                "ddt_frame": tracker.ddt_frame,
                "break_frame": output.break_frame,
                "break_reason": output.break_reason,
                "calibration_m_per_px": calibration,
                "position_offset_m": position_offset,
                "first_position_px": output.rows[0][2] if output.rows else None,
                "last_position_px": output.rows[-1][2] if output.rows else None,
                "wall_s": round(wall_s, 3),
                "frames_per_s": round(n_frames / wall_s, 1) if wall_s > 0 else None,
                **(
                    {"phase_timings": output.phase_timings}
                    if getattr(output, "phase_timings", None)
                    else {}
                ),
            }
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "source": self.source_name,
            "config": _jsonable(self.config_echo),
            "files": self.files,
            "failures": self.failures,
            "total_files": len(self.files),
            "total_failures": len(self.failures),
            "total_rows": sum(f["rows"] for f in self.files),
            "total_wall_s": round(time.time() - self._t0, 3),
        }

    def write(self, output_dir, rank: int = 0) -> Path:
        """Write the summary JSON into the output directory.

        Rank 0 writes ``run-summary.json``; other processes write
        ``run-summary.rank{N}.json`` so concurrent ranks never clobber
        each other's file."""
        name = "run-summary.json" if rank == 0 else f"run-summary.rank{rank}.json"
        path = Path(output_dir) / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.as_dict(), indent=2, default=str) + "\n")
        return path


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _jsonable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj
