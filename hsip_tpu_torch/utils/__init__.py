"""Utilities: device selection, logging, profiling, run summaries, checkpoints."""

from .backend import resolve_device
from .checkpoint import BatchCheckpoint
from .logging import get_logger, set_log_level
from .profiling import StageTimes
from .summary import RunSummary

__all__ = [
    "BatchCheckpoint",
    "RunSummary",
    "StageTimes",
    "get_logger",
    "resolve_device",
    "set_log_level",
]
