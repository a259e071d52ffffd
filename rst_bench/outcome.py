"""What a driver hands back from one run, for ``run.py`` and the metric readers."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .tracer import TraceSummary


@dataclasses.dataclass
class Outcome:
    cfg: dict
    attempted: int
    failed: int
    window_start: float                # perf_counter at the window's first timed call
    memory_peak_bytes: int             # torch.cuda.max_memory_allocated over set-up and window
    end_to_end: Dict[str, float]       # the end-to-end metrics this traffic measures
    readings: Dict[str, float]         # window counts and spans for the per-layer readers
    checks: Dict[str, Tuple[float, Optional[float]]]  # compared number -> (value, limit)
    trace: Optional[TraceSummary] = None

    @property
    def correct(self) -> bool:
        """Every compared number at or under its limit (a missing limit, or
        a NaN, fails)."""
        return bool(self.checks) and all(
            limit is not None and value <= limit for value, limit in self.checks.values())
