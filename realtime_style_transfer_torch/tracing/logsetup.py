"""Logging configuration: colored console, per-run logfile, stderr rate limiting.

Port of ``realtime_style_transfer_tpu/tracing/logsetup.py`` without its JAX
platform hook: ``setup()`` configures the root logger once, explicitly, so
imports stay free of side effects; ``enable_logfile(log_dir)`` adds a plain
text ``log.txt`` under a run directory; ``RateLimitedStream`` drops bursts of
one repeated line.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

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


class RateLimitedStream:
    """A stream wrapper that drops a line repeated within ``min_interval_s``
    and reports how many it dropped before the next different line."""

    def __init__(self, wrapped, min_interval_s: float = 0.25):
        self._wrapped = wrapped
        self._min_interval = min_interval_s
        self._last_write = 0.0
        self._last_msg = None
        self._suppressed = 0

    def write(self, msg):
        now = time.monotonic()
        if msg == self._last_msg and (now - self._last_write) < self._min_interval:
            self._suppressed += 1
            return
        if self._suppressed:
            self._wrapped.write(f"[{self._suppressed} duplicate lines suppressed]\n")
            self._suppressed = 0
        self._last_msg = msg
        self._last_write = now
        self._wrapped.write(msg)

    def flush(self):
        self._wrapped.flush()

    def __getattr__(self, name):
        return getattr(self._wrapped, name)


NOISY_LOGGERS = ("PIL",)


def setup(level: int = logging.INFO, rate_limit_stderr: bool = False) -> None:
    """Configure the root logger once (idempotent)."""
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(
        RateLimitedStream(sys.stderr) if rate_limit_stderr else sys.stderr
    )
    handler.setFormatter(ColorFormatter())
    root = logging.getLogger()
    root.setLevel(level)
    root.addHandler(handler)
    for name in NOISY_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    _configured = True


def enable_logfile(log_dir) -> logging.FileHandler:
    """Attach a plain-text ``log.txt`` handler under ``log_dir`` to the root
    logger and return it (its ``baseFilename`` is the file); the caller
    removes and closes it when the run ends."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(log_dir / "log.txt")
    fh.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s | %(message)s")
    )
    logging.getLogger().addHandler(fh)
    return fh
