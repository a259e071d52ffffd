"""The program's spans laid over a traced window: which stage each kernel ran
for, and which span the host was in as the card went idle.

The spans come from ``realtime_style_transfer_torch.tracing.spans``, recorded
around the same block as a :class:`.tracer.Tracer`.  They are stamped in Unix
ns, the clock of the trace's events, so the two can be laid over each other.

- **Kernel to stage.**  A kernel launched from Python carries the CUPTI
  correlation id of the runtime call that launched it.  That call lies inside
  a ``launch`` span, whose parent is the ``stage.<name>`` span of its stage.
  The kernels of a CUDA graph replay all carry the correlation id of the
  one runtime call that launched the graph.  They are put to stages by their
  order within the replay, against the stage order the graph was captured in
  (``ChunkGraph.stages``).
- **Idle gaps.**  :meth:`SpanTrace.idle_gaps` splits the ``host: between CUDA
  calls`` entry of :meth:`.tracer.TraceSummary.idle_gaps` by the innermost
  span open as each gap opened (``host: in span <name>``).  Gaps that open
  inside a runtime call keep their names.  With no spans the list is the
  same as the summary's.

``rst_bench/spans_report.py`` prints what this reads.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .tracer import TOP, TraceSummary, _ns
from .yardstick import HBM_BYTES_PER_S, bound_s, finish_work, stages

STAGE_KERNELS = ("conv_window_kernel", "conv_halo_kernel", "finish_kernel")
Event = Tuple[int, int, str, int]  # (start ns, end ns, name, correlation id)


def stage_kernel(name: str) -> bool:
    """Whether a device event is a launch of ``conv_stage.cu`` or ``finish.cu``."""
    return any(k in name for k in STAGE_KERNELS)


class Assigned(NamedTuple):
    event: Event
    stage: str     # a stage of yardstick.stages, or "finish"
    frame: int     # the frame id of the call that launched it (-1 without spans)


class SpanTrace(TraceSummary):
    """A traced window's device events and runtime calls, each as (start ns,
    end ns, name, correlation id), with the spans recorded over it and, for
    chunk calls, the stage of each launch of the replayed graph in order."""

    def __init__(self, device: List[Event], host: List[Event], window_s: float,
                 spans: Sequence = (), replay_stages: Sequence[str] = ()):
        super().__init__([e[:3] for e in device], [e[:3] for e in host], window_s)
        self.events = sorted(device)
        self.calls = {e[3]: e for e in host}
        self.spans = list(spans)
        self._starts = [s.start_ns for s in self.spans]
        self.replay_stages = tuple(replay_stages)
        self.assigned = self._assign()

    @classmethod
    def from_tracer(cls, tracer, window_s: float, spans: Sequence = (),
                    replay_stages: Sequence[str] = ()) -> "SpanTrace":
        from torch.autograd import DeviceType

        device, host = [], []
        for e in tracer.events:
            start = _ns(e, "start")
            event = (start, start + _ns(e, "duration"), e.name(), e.correlation_id())
            (device if e.device_type() == DeviceType.CUDA else host).append(event)
        return cls(device, host, window_s, spans, replay_stages)

    # ---- spans --------------------------------------------------------------

    def span_at(self, t: int) -> int:
        """Index of the innermost span open at ``t``, or -1.  Spans nest, so
        it is the last one opened at or before ``t``, or an ancestor of it."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and not t < self.spans[i].end_ns:
            i = self.spans[i].parent
        return i

    def _stage_of(self, i: int) -> Optional[str]:
        """The stage whose ``stage.*`` span is span ``i`` or an ancestor of it."""
        while i >= 0:
            name = self.spans[i].name
            if name.startswith("stage."):
                return name[len("stage."):]
            i = self.spans[i].parent
        return None

    def _launched(self) -> Dict[int, List[Event]]:
        """The stage kernels of each runtime call in the trace, in order,
        by the call's correlation id."""
        out: Dict[int, List[Event]] = defaultdict(list)
        for ev in self.events:
            if stage_kernel(ev[2]) and ev[3] in self.calls:
                out[ev[3]].append(ev)
        return out

    def _assign(self) -> List[Assigned]:
        """Each stage kernel with its stage: one launched alone by a call
        inside a ``launch`` span goes to that span's stage; the kernels of a
        call that launched as many as the replayed graph holds go to the
        graph's stages in order.  Any other is left out."""
        out = []
        for corr, evs in self._launched().items():
            i = self.span_at(self.calls[corr][0])
            frame = self.spans[i].frame if i >= 0 else -1
            if len(evs) == 1 and i >= 0 and self.spans[i].name == "launch":
                stage = self._stage_of(i)
                if stage is not None:
                    out.append(Assigned(evs[0], stage, frame))
            elif len(evs) > 1 and len(evs) == len(self.replay_stages):
                out.extend(Assigned(ev, stage, frame)
                           for ev, stage in zip(evs, self.replay_stages))
        out.sort()
        return out

    def launch_alignment(self) -> Dict[str, int]:
        """The runtime calls that launched one stage kernel each (from
        Python, not by a graph) against the ``launch`` spans: how many lie
        wholly inside one, the largest distance in ns by which one lies
        outside the nearest, and the range of clock offsets (ns added to the
        trace's times) under which every call that lies inside one still
        would."""
        launches = [s for s in self.spans if s.name == "launch" and s.end_ns]
        starts = [s.start_ns for s in launches]
        calls = [self.calls[corr] for corr, evs in self._launched().items() if len(evs) == 1]
        inside, worst, lo, hi = 0, 0, -(1 << 62), 1 << 62
        for start, end, _name, _corr in calls:
            j = bisect.bisect_right(starts, start)
            near = min(launches[max(j - 1, 0):j + 1], default=None,
                       key=lambda s: max(s.start_ns - start, end - s.end_ns, 0))
            if near is None:
                continue
            out = max(near.start_ns - start, end - near.end_ns, 0)
            worst = max(worst, out)
            if out == 0:
                inside += 1
                lo, hi = max(lo, near.start_ns - start), min(hi, near.end_ns - end)
        return {"calls": len(calls), "inside": inside, "worst_outside_ns": worst,
                "offset_lo_ns": lo, "offset_hi_ns": hi}

    # ---- idle gaps ----------------------------------------------------------

    def _gaps(self):
        """(start, end, runtime call in progress or None) of each device idle
        gap between the first and the last device activity: the walk of
        :meth:`.tracer.TraceSummary.idle_gaps`."""
        starts = [s for s, _, _ in self.host]
        for (_, gap_start), (gap_end, _) in zip(self._merged, self._merged[1:]):
            i = bisect.bisect_right(starts, gap_start) - 1
            call = None
            while i >= 0:
                s, e, name = self.host[i]
                if e > gap_start:
                    call = name
                    break
                if gap_start - s > 10_000_000:   # no call that old is still open
                    break
                i -= 1
            yield gap_start, gap_end, call

    def idle_gaps(self, top: int = TOP) -> List[List]:
        """:meth:`.tracer.TraceSummary.idle_gaps` with ``host: between CUDA
        calls`` split by the innermost span open as each gap opened."""
        by_host: Dict[str, float] = defaultdict(float)
        for gap_start, gap_end, call in self._gaps():
            if call is not None:
                name = f"host: in {call}"
            else:
                i = self.span_at(gap_start)
                name = (f"host: in span {self.spans[i].name}" if i >= 0
                        else "host: between CUDA calls")
            by_host[name] += (gap_end - gap_start) / 1e9
        ranked = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return [[name, seconds] for name, seconds in ranked]

    def stage_idle_s(self) -> Dict[str, float]:
        """Device idle seconds by the stage whose span was open as each gap
        opened, inside a runtime call or not."""
        out: Dict[str, float] = defaultdict(float)
        for gap_start, gap_end, _call in self._gaps():
            stage = self._stage_of(self.span_at(gap_start))
            if stage is not None:
                out[stage] += (gap_end - gap_start) / 1e9
        return out

    # ---- the frame loop's readings -----------------------------------------

    def frames(self) -> int:
        """Frames the trace finished that a stage was found for: one
        ``finish`` launch a frame."""
        return sum(1 for a in self.assigned if a.stage == "finish")

    def span_ms(self) -> Dict[str, float]:
        """Mean ms of the spans of each name, less the ``launch`` spans
        inside them: the host's own time in them, around the runtime calls."""
        launched: Dict[int, int] = defaultdict(int)
        for s in self.spans:
            if s.name == "launch" and s.end_ns:
                i = s.parent
                while i >= 0:
                    launched[i] += s.end_ns - s.start_ns
                    i = self.spans[i].parent
        total: Dict[str, int] = defaultdict(int)
        count: Dict[str, int] = defaultdict(int)
        for i, s in enumerate(self.spans):
            if s.end_ns and s.name != "launch":
                total[s.name] += s.end_ns - s.start_ns - launched[i]
                count[s.name] += 1
        return {name: total[name] / count[name] / 1e6 for name in total}

    def frame_py_ms(self) -> Optional[float]:
        """Mean ms a ``frame`` span spends outside its ``launch`` spans: the
        Python around the launches of a ``stylize_prepacked`` call."""
        return self.span_ms().get("frame")

    def frame_idle_share(self) -> Optional[float]:
        """% of the window with no CUDA activity while a ``frame`` span was
        open: the part of the idle share the frame call's own host work
        leaves (the rest falls between calls)."""
        frames = [(s.start_ns, s.end_ns) for s in self.spans if s.name == "frame" and s.end_ns]
        if not frames or not self.window_s:
            return None
        merged, idle, j = self._merged, 0, 0
        for start, end in frames:   # in order, and apart
            while j < len(merged) and merged[j][1] <= start:
                j += 1
            busy, k = 0, j
            while k < len(merged) and merged[k][0] < end:
                busy += min(end, merged[k][1]) - max(start, merged[k][0])
                k += 1
            idle += end - start - busy
        return 100.0 * idle / 1e9 / self.window_s

    def stage_table(self, cfg: dict) -> List[dict]:
        """One row a stage of :func:`.yardstick.stages` and one for
        ``finish``: launches a frame, device ms a launch, the frozen bound a
        launch, the share of it, host ms a frame in its span outside the
        launch (None without per-frame spans) and idle ms a frame opened in
        its span."""
        frames = self.frames()
        seconds: Dict[str, float] = defaultdict(float)
        count: Dict[str, int] = defaultdict(int)
        for a in self.assigned:
            seconds[a.stage] += (a.event[1] - a.event[0]) / 1e9
            count[a.stage] += 1
        idle = self.stage_idle_s()
        host = self.span_ms()
        bounds = [(st.name, bound_s(st.ops, st.bytes)) for st in stages(cfg)]
        bounds.append(("finish", finish_work(cfg)[1] / HBM_BYTES_PER_S))
        rows = []
        for name, bound in bounds:
            n = count[name]
            rows.append({
                "stage": name,
                "launches_per_frame": n / frames if frames else 0.0,
                "device_ms": seconds[name] / n * 1e3 if n else None,
                "bound_ms": bound * 1e3,
                "share": 100.0 * bound * n / seconds[name] if n and seconds[name] else None,
                "host_ms": host.get(f"stage.{name}"),
                "idle_ms_per_frame": idle[name] / frames * 1e3 if frames else None,
            })
        return rows

    def other_kernels(self) -> List[List]:
        """Device events a frame that no stage was found for (fills, copies,
        the unpack): [name, events a frame, device ms a frame]."""
        frames = self.frames()
        mine = {a.event for a in self.assigned}
        by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        for ev in self.events:
            if ev not in mine:
                by_name[ev[2]][0] += 1
                by_name[ev[2]][1] += (ev[1] - ev[0]) / 1e6
        if not frames:
            return []
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        return [[name, n / frames, ms / frames] for name, (n, ms) in ranked]
