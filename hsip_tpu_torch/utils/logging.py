"""Structured logging for pipeline diagnostics.

Standard-library logging with a compact key=value formatter. User-facing
progress output intentionally remains ``print`` (matching the reference's
console UX); this logger carries the DIAGNOSTIC layer (per-file timings,
chunk stats) controlled by ``HSIP_LOG_LEVEL`` or :func:`set_log_level`.
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger", "set_log_level"]

_CONFIGURED = False


class _KVFormatter(logging.Formatter):
    """`ts level logger message key=value ...` lines."""

    def format(self, record: logging.LogRecord) -> str:
        base = (
            f"{self.formatTime(record, '%H:%M:%S')} "
            f"{record.levelname:<7} {record.name}: {record.getMessage()}"
        )
        extras = getattr(record, "kv", None)
        if extras:
            base += " " + " ".join(f"{k}={v}" for k, v in extras.items())
        return base


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_KVFormatter())
    root = logging.getLogger("hsip_tpu_torch")
    root.addHandler(handler)
    root.propagate = False
    level = os.environ.get("HSIP_LOG_LEVEL", "INFO").upper()
    try:
        root.setLevel(level)
    except ValueError:
        # A diagnostic knob must never take down processing: clamp and say so.
        root.setLevel(logging.INFO)
        root.warning("ignoring invalid HSIP_LOG_LEVEL=%r (using INFO)", level)
    _CONFIGURED = True


def get_logger(name: str = "hsip_tpu_torch") -> logging.Logger:
    """Namespaced logger under the 'hsip_tpu_torch' root."""
    _configure()
    if not name.startswith("hsip_tpu_torch"):
        name = f"hsip_tpu_torch.{name}"
    return logging.getLogger(name)


def set_log_level(level: str) -> None:
    """Set the framework-wide log level ('DEBUG', 'INFO', ...)."""
    _configure()
    logging.getLogger("hsip_tpu_torch").setLevel(level.upper())


def kv(logger: logging.Logger, level: int, msg: str, **fields) -> None:
    """Log with structured key=value fields."""
    logger.log(level, msg, extra={"kv": fields})
