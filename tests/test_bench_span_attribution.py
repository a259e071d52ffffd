"""The benchmark's reading of the program's spans against a device trace
(``rst_bench/attribution.py``), on synthetic traces: kernels put to stages
by correlation id and by their order in a graph replay, the idle gaps split
by span, and the frame loop's two readings."""

import random

import pytest

from realtime_style_transfer_torch.tracing.spans import Span
from rst_bench import yardstick
from rst_bench.attribution import SpanTrace
from rst_bench.tracer import TraceSummary

CFG = yardstick.load_config("rst_bench/configs/rst-960-120-128-17.json")
STAGES = [st.name for st in yardstick.stages(CFG)] + ["finish"]
PATH = {st.name: st.path for st in yardstick.stages(CFG)}


def kernel_name(stage):
    if stage == "finish":
        return "(anonymous namespace)::finish_kernel(__nv_bfloat16 const*, float const*)"
    kind = "window" if PATH[stage] == "window" else "halo"
    return f"void (anonymous namespace)::conv_{kind}_kernel<32, false>(ConvParams)"


class Trace:
    """A synthetic trace with spans, built call by call."""

    def __init__(self):
        self.device, self.host, self.spans, self.corr = [], [], [], 0
        self.frame = -1

    def span(self, name, start, end, parent):
        self.spans.append(Span(name, start, end, parent, self.frame))
        return len(self.spans) - 1

    def call(self, name, start, end):
        self.corr += 1
        self.host.append((start, end, name, self.corr))
        return self.corr

    def frame_call(self, t0):
        """One stylize_prepacked call: stage k's span at t0 + 1000 k for 900
        ns, its launch span 300-600 into it, the runtime call 350-550 and the
        kernel 500-800; the unpack's copy 17020-17060; the frame span from
        t0 - 100 to t0 + 17100."""
        self.frame += 1
        top = self.span("frame", t0 - 100, t0 + 17100, -1)
        self.span("frame.prep", t0 - 90, t0 - 10, top)
        for k, stage in enumerate(STAGES):
            base = t0 + 1000 * k
            parent = self.span(f"stage.{stage}", base, base + 900, top)
            self.span("launch", base + 300, base + 600, parent)
            corr = self.call("cudaLaunchKernel", base + 350, base + 550)
            self.device.append((base + 500, base + 800, kernel_name(stage), corr))
        unpack = self.span("frame.unpack", t0 + 17000, t0 + 17050, top)
        corr = self.call("cudaLaunchKernel", t0 + 17010, t0 + 17015)
        self.device.append((t0 + 17020, t0 + 17060, "elementwise_kernel<copy>", corr))
        return unpack

    def chunk_call(self, t0, n, api="cudaGraphLaunch"):
        """One stylize_prepacked_chunk call of n frames: the graph's kernels
        (a fill, then 17 stage launches a frame, 100 ns each) under one
        runtime call, ``api``."""
        self.frame += 1
        top = self.span("chunk", t0, t0 + 20000, -1)
        self.span("chunk.copy_in", t0 + 10, t0 + 100, top)
        self.span("chunk.replay", t0 + 200, t0 + 400, top)
        corr = self.call(api, t0 + 250, t0 + 350)
        self.device.append((t0 + 300, t0 + 310, "vectorized_elementwise_kernel<fill>", corr))
        t = t0 + 400
        for _ in range(n):
            for stage in STAGES:
                self.device.append((t, t + 100, kernel_name(stage), corr))
                t += 100
        self.span("chunk.unpack", t0 + 19000, t0 + 19100, top)

    def summary(self, window_s, spans=True, replay_stages=()):
        return SpanTrace(list(self.device), list(self.host), window_s,
                         self.spans if spans else (), replay_stages)


def test_frame_kernels_go_to_the_stage_of_their_launch_span():
    tr = Trace()
    for f in range(3):
        tr.frame_call(20000 * f)
    s = tr.summary(60e-6)
    assert [(a.stage, a.frame) for a in s.assigned] == [
        (stage, f) for f in range(3) for stage in STAGES]
    assert s.frames() == 3
    assert s.launch_alignment() == {"calls": 51, "inside": 51, "worst_outside_ns": 0,
                                    "offset_lo_ns": -50, "offset_hi_ns": 50}
    rows = s.stage_table(CFG)
    assert [r["stage"] for r in rows] == STAGES
    for r, st in zip(rows, yardstick.stages(CFG)):
        assert r["launches_per_frame"] == 1.0
        assert r["device_ms"] == pytest.approx(300e-6)
        assert r["bound_ms"] == pytest.approx(yardstick.bound_s(st.ops, st.bytes) * 1e3)
        assert r["share"] == pytest.approx(100 * r["bound_ms"] / r["device_ms"])
    assert all(r["host_ms"] == pytest.approx(600e-6) for r in rows)   # 900 less the launch's 300
    assert s.span_ms() == pytest.approx({"frame": (17200 - 17 * 300) * 1e-6, "frame.prep": 80e-6,
                                         **{f"stage.{st}": 600e-6 for st in STAGES},
                                         "frame.unpack": 50e-6})
    idle = {r["stage"]: r["idle_ms_per_frame"] for r in rows}
    assert idle == pytest.approx({**{st: 700e-6 for st in STAGES[:-1]}, "finish": 220e-6})
    assert s.other_kernels() == [["elementwise_kernel<copy>", 1.0, pytest.approx(40e-6)]]


def test_a_call_outside_every_launch_span_puts_its_kernel_nowhere():
    tr = Trace()
    tr.frame_call(0)
    start, end, name, corr = tr.host[3]
    tr.host[3] = (start - 400, end - 400, name, corr)   # before stage 3's launch span
    s = tr.summary(20e-6)
    assert [a.stage for a in s.assigned] == STAGES[:3] + STAGES[4:]
    align = s.launch_alignment()
    assert align["inside"] == 16 and align["worst_outside_ns"] == 350


@pytest.mark.parametrize("api", ["cudaGraphLaunch", "cudaStreamIsCapturing"])
def test_replay_kernels_go_to_the_stages_in_the_graphs_order(api):
    tr = Trace()
    tr.chunk_call(0, 3)
    tr.chunk_call(30000, 3, api)   # whatever runtime call CUPTI ties the replay to
    s = tr.summary(60e-6, replay_stages=tuple(STAGES) * 3)
    assert [(a.stage, a.frame) for a in s.assigned] == [
        (stage, c) for c in range(2) for _ in range(3) for stage in STAGES]
    assert s.frames() == 6
    rows = s.stage_table(CFG)
    assert all(r["launches_per_frame"] == 1.0 for r in rows)
    assert all(r["device_ms"] == pytest.approx(100e-6) for r in rows)
    assert all(r["host_ms"] is None for r in rows)
    assert s.other_kernels()[0][:2] == ["vectorized_elementwise_kernel<fill>", 2 / 6]
    # a graph of another length is not guessed at
    assert tr.summary(60e-6, replay_stages=tuple(STAGES) * 2).assigned == []


def test_idle_gaps_are_split_by_the_innermost_span():
    tr = Trace()
    for f in range(3):
        tr.frame_call(20000 * f)
    gaps = dict(tr.summary(60e-6).idle_gaps(top=64))
    want = {f"host: in span stage.{st}": 3 * 700e-9 for st in STAGES[:-1]}
    want["host: in span stage.finish"] = 3 * 220e-9
    want["host: in span frame"] = 2 * (20500 - 17060) * 1e-9
    assert gaps == pytest.approx(want)
    # the summary's ten largest, as the tracer lists them
    assert len(tr.summary(60e-6).idle_gaps()) == 10


def test_gaps_inside_a_runtime_call_keep_its_name():
    tr = Trace()
    tr.frame_call(0)
    tr.host.append((16750, 16900, "cudaStreamSynchronize", 999))   # open at 16800
    gaps = dict(tr.summary(20e-6).idle_gaps(top=64))
    assert gaps["host: in cudaStreamSynchronize"] == pytest.approx(220e-9)
    assert "host: in span stage.finish" not in gaps


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_idle_gaps_without_spans_are_the_tracers_own(seed):
    rng = random.Random(seed)
    device, host, t = [], [], 0
    names = ["cudaLaunchKernel", "cudaEventSynchronize", "cudaMemcpyAsync"]
    for i in range(400):
        t += rng.randrange(0, 30_000_000 if i % 97 == 0 else 5000)
        if rng.random() < 0.5:
            host.append((t, t + rng.randrange(1, 4000), rng.choice(names), i))
        device.append((t + rng.randrange(0, 3000), t + rng.randrange(3000, 9000), "k", i))
    want = TraceSummary([e[:3] for e in device], [e[:3] for e in host], 1.0).idle_gaps()
    got = SpanTrace(list(device), list(host), 1.0).idle_gaps()
    assert got == want and "host: between CUDA calls" in dict(got)
    assert repr(got) == repr(want)


def test_frame_readings_from_the_spans_and_none_without():
    tr = Trace()
    for f in range(3):
        tr.frame_call(20000 * f)
    s = tr.summary(60e-6)
    # a frame of 17200 ns, 17 launch spans of 300 inside it
    assert s.frame_py_ms() == pytest.approx((17200 - 17 * 300) * 1e-6)
    # idle inside each frame span: 17200 - 17 kernels of 300 - the copy's 40
    assert s.frame_idle_share() == pytest.approx(100 * 3 * (17200 - 17 * 300 - 40) / 60000)
    idle_share = 100 * (1 - s.busy_s / s.window_s)
    assert s.frame_idle_share() <= idle_share
    bare = tr.summary(60e-6, spans=False)
    assert bare.frame_py_ms() is None and bare.frame_idle_share() is None
    assert bare.assigned == [] and bare.frames() == 0
    chunks = Trace()
    chunks.chunk_call(0, 3)
    assert chunks.summary(20e-6, replay_stages=tuple(STAGES) * 3).frame_py_ms() is None
