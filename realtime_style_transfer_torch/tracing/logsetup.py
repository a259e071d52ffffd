"""Logging configuration: a colored console handler on the root logger.

Port of ``setup()`` of ``realtime_style_transfer_tpu/tracing/logsetup.py``
without its JAX platform hook: it configures the root logger once,
explicitly, so imports stay free of side effects.  The per-run logfile and the
rate-limited stderr come with the trainer, which needs them.
"""

from __future__ import annotations

import logging
import sys

RESET = "\x1b[0m"
COLORS = {
    logging.DEBUG: "\x1b[38;5;245m",   # grey
    logging.INFO: "\x1b[38;5;39m",     # blue
    logging.WARNING: "\x1b[38;5;214m",  # orange
    logging.ERROR: "\x1b[31m",         # red
    logging.CRITICAL: "\x1b[41m",      # red background
}

_configured = False


class ColorFormatter(logging.Formatter):
    """Per-level colored formats: terse for INFO, detailed for WARNING+."""

    def format(self, record: logging.LogRecord) -> str:
        if record.levelno >= logging.WARNING:
            fmt = "%(asctime)s %(levelname)s %(name)s:%(lineno)d | %(message)s"
        else:
            fmt = "%(asctime)s %(levelname)s | %(message)s"
        color = COLORS.get(record.levelno, "")
        return color + logging.Formatter(fmt).format(record) + RESET


NOISY_LOGGERS = ("PIL",)


def setup(level: int = logging.INFO) -> None:
    """Configure the root logger once (idempotent)."""
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(ColorFormatter())
    root = logging.getLogger()
    root.setLevel(level)
    root.addHandler(handler)
    for name in NOISY_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    _configured = True
