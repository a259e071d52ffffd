"""Profiling hooks: a ``torch.profiler`` trace and per-frame wall-clock timers.

Port of ``realtime_style_transfer_tpu/tracing/profiler.py``: ``trace(log_dir)``
captures a TensorBoard-viewable profile (``torch.profiler`` in place of
``jax.profiler``; host activity, and the card's where CUDA is available);
``FrameTimer`` tracks per-frame latency percentiles.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace written under ``log_dir`` if one is given;
    no-op otherwise."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class FrameTimer:
    """Collects per-frame wall-clock latencies and reports percentiles."""

    def __init__(self):
        self._latencies: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        assert self._t0 is not None, "start() not called"
        self._latencies.append(time.perf_counter() - self._t0)
        self._t0 = None

    def add(self, seconds: float) -> None:
        """Record a latency measured elsewhere (say by the frame loop)."""
        self._latencies.append(float(seconds))

    @contextlib.contextmanager
    def frame(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def percentiles(self) -> Dict[str, float]:
        if not self._latencies:
            return {}
        xs = sorted(self._latencies)

        def pick(q):
            return xs[min(len(xs) - 1, int(q * len(xs)))]
        return {
            "p50_ms": pick(0.50) * 1e3,
            "p90_ms": pick(0.90) * 1e3,
            "p99_ms": pick(0.99) * 1e3,
            "mean_ms": sum(xs) / len(xs) * 1e3,
            "frames": float(len(xs)),
        }
