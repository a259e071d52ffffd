"""The device trace of a run's window, read from ``torch.profiler``'s CUPTI
activity, and what the per-layer metrics take from it.

Only CUDA activity is recorded: the device's kernels, copies and fills, and
the host's CUDA runtime calls (launches, synchronizations), each with its
start and end on one clock.  Tracing CPU operators as well would put the
profiler's cost on every operator of the frame loop, the host work that the
per-layer metrics measure.  The profiler is driven below its Python wrapper,
whose ``__exit__`` turns every event into a Python object on some versions,
seconds for a window of a hundred thousand kernels.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10  # entries of each list of the breakdown


def _ns(event, what: str) -> int:
    """An event's start or duration in ns, from whichever accessor this
    build of torch has."""
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


class Tracer:
    """``with Tracer() as t:`` records the CUDA activity of the block; then
    ``t.summary()`` reduces it."""

    def __enter__(self) -> "Tracer":
        from torch.autograd import _disable_profiler, _enable_profiler, _prepare_profiler
        from torch.autograd.profiler import profile

        self._disable = _disable_profiler
        # the wrapper only builds the config and the activity set here
        wrapper = profile(use_device="cuda", use_kineto=True)
        activities = {a for a in wrapper.kineto_activities if "CUDA" in str(a)}
        if not activities:
            raise RuntimeError("torch.profiler offers no CUDA activity on this build")
        config = wrapper.config()
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities)
        return self

    def __exit__(self, *exc) -> bool:
        self.events = self._disable().events()
        return False

    def summary(self, window_s: float) -> "TraceSummary":
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.events:
            start = _ns(e, "start")
            span = (start, start + _ns(e, "duration"), e.name())
            (device if e.device_type() == DeviceType.CUDA else host).append(span)
        return TraceSummary(device, host, window_s)


class TraceSummary:
    """Device intervals (kernels, copies, fills) and host runtime calls of a
    traced window, as (start ns, end ns, name)."""

    def __init__(self, device: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]],
                 window_s: float):
        self.window_s = window_s
        device.sort()
        host.sort()
        self.device, self.host = device, host
        merged: List[List[int]] = []
        for s, e, _ in device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        # from the first device activity's start to the last one's end
        self.span_s = (merged[-1][1] - merged[0][0]) / 1e9 if merged else 0.0
        self._merged = merged
        self.by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for s, e, name in device:
            entry = self.by_name[name]
            entry[0] += (e - s) / 1e9
            entry[1] += 1

    def kernel(self, fragment: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds
        ``fragment``."""
        seconds, count = 0.0, 0
        for name, (s, n) in self.by_name.items():
            if fragment in name:
                seconds, count = seconds + s, count + n
        return seconds, count

    def device_ops(self) -> List[List]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[name, seconds] for name, (seconds, _n) in top]

    def idle_gaps(self) -> List[List]:
        """Device idle time between the first and the last device activity,
        summed by the host runtime call in progress as each gap opened
        (``host: between CUDA calls`` where there was none: Python)."""
        starts = [s for s, _, _ in self.host]
        by_host: Dict[str, float] = defaultdict(float)
        for (_, gap_start), (gap_end, _) in zip(self._merged, self._merged[1:]):
            i = bisect.bisect_right(starts, gap_start) - 1
            name = "host: between CUDA calls"
            while i >= 0:
                s, e, call = self.host[i]
                if e > gap_start:
                    name = f"host: in {call}"
                    break
                if gap_start - s > 10_000_000:   # no call that old is still open
                    break
                i -= 1
            by_host[name] += (gap_end - gap_start) / 1e9
        top = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, seconds] for name, seconds in top]
