"""Batch checkpoint/resume: crash-safe progress for long multi-video runs.

The reference wrote results only at end-of-video and restarted from scratch
on any crash (SURVEY.md §5.3-5.4). Here a tiny JSON ledger in the output
directory records which recordings completed (with their result-table
checksums), so an interrupted batch resumes exactly where it stopped:

    ckpt = BatchCheckpoint(output_dir)
    for f in files:
        if ckpt.is_done(f.name):
            continue
        ... process ...
        ckpt.mark_done(f.name, rows=n)

Writes are atomic (tmp + rename) so a crash mid-write never corrupts the
ledger.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

__all__ = ["BatchCheckpoint"]


class BatchCheckpoint:
    """JSON ledger of completed recordings for one output directory.

    Multi-process runs pass their ``rank``: each process owns its own ledger
    file (no lost updates from concurrent whole-file rewrites), and
    :meth:`is_done` consults ALL ranks' ledgers.
    """

    FILENAME = "hsip-checkpoint.json"

    def __init__(
        self,
        output_dir,
        run_config_hash: Optional[str] = None,
        rank: int = 0,
    ):
        self.directory = Path(output_dir)
        name = (
            self.FILENAME if rank == 0 else f"hsip-checkpoint.rank{rank}.json"
        )
        self.path = self.directory / name
        self.run_config_hash = run_config_hash
        self._others = None  # other-rank done-set cache (_other_ranks_done)
        self._state: Dict[str, Any] = {"config_hash": run_config_hash, "done": {}}
        if self.path.exists():
            try:
                loaded = json.loads(self.path.read_text())
                # A changed configuration invalidates prior progress.
                if (
                    run_config_hash is None
                    or loaded.get("config_hash") == run_config_hash
                ):
                    self._state = loaded
                    self._state.setdefault("done", {})
            except (json.JSONDecodeError, OSError):
                pass  # corrupt ledger: start fresh

    def is_done(self, name: str) -> bool:
        if name in self._state["done"]:
            return True
        return name in self._other_ranks_done()

    def _other_ranks_done(self) -> frozenset:
        """Names completed by OTHER ranks' ledgers (same config hash).

        Loaded once and cached: resume filtering calls is_done per file, and
        the other ledgers cannot gain entries between construction and the
        post-setup barrier (each rank only marks files it owns, after the
        barrier) — re-parsing every ledger per file was O(files x ranks)
        reads on what can be a network filesystem.
        """
        if getattr(self, "_others", None) is None:
            done = set()
            for other in self.directory.glob("hsip-checkpoint*.json"):
                if other == self.path:
                    continue
                try:
                    loaded = json.loads(other.read_text())
                except (json.JSONDecodeError, OSError):
                    continue
                if (
                    self.run_config_hash is None
                    or loaded.get("config_hash") == self.run_config_hash
                ):
                    done.update(loaded.get("done", {}))
            self._others = frozenset(done)
        return self._others

    def mark_done(self, name: str, **info) -> None:
        self._state["done"][name] = {"ts": time.time(), **info}
        self._flush()

    def clear(self) -> None:
        """Reset progress: removes EVERY rank's ledger in the directory
        (is_done would otherwise trust stale completions from prior runs
        with a different rank count)."""
        self._state = {"config_hash": self.run_config_hash, "done": {}}
        self._others = None  # the deleted ledgers must stop counting as done
        for ledger in self.directory.glob("hsip-checkpoint*.json"):
            try:
                ledger.unlink()
            except OSError:
                pass

    @property
    def completed(self) -> Dict[str, Any]:
        return dict(self._state["done"])

    def _flush(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._state, indent=2) + "\n")
        os.replace(tmp, self.path)
