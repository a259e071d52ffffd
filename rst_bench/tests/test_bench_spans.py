"""The program's spans against the device trace on the card (``-m chip``): a
traced window of rst-960 frames, the sync traffic's per-frame calls and the
stream traffic's chunk replays, laid over its CUDA activity."""

import json
from collections import Counter, defaultdict

import pytest

from rst_bench import spans_report, yardstick
from rst_bench.attribution import stage_kernel

CELLS = {"sync": "rst960-sync", "stream": "rst960-stream"}
SEED = 2_600_000_021


def _kernel_of(cfg):
    """Each stage's kernel name fragment, from the yardstick's paths."""
    out = {st.name: "conv_window_kernel" if st.path == "window" else "conv_halo_kernel"
           for st in yardstick.stages(cfg)}
    out["finish"] = "finish_kernel"
    return out


def _traced(traffic, cuda):
    cfg, st = spans_report.setup(CELLS[traffic], SEED, cuda)
    return cfg, st, spans_report.traced(st, 2.0)


@pytest.mark.chip
def test_frame_kernels_map_onto_the_stages_through_their_launch_spans(cuda):
    cfg, _st, trace = _traced("sync", cuda)
    align = trace.launch_alignment()
    print("launch spans:", json.dumps(align))
    assert align["calls"] > 1000
    assert align["inside"] >= 0.999 * align["calls"]
    order = [st.name for st in yardstick.stages(cfg)] + ["finish"]
    kernel = _kernel_of(cfg)
    by_frame = defaultdict(list)
    for a in trace.assigned:
        assert kernel[a.stage] in a.event[2], (a.stage, a.event[2])
        by_frame[a.frame].append(a.stage)
    frames = [s for s in trace.spans if s.name == "frame"]
    complete = [stages for stages in by_frame.values() if stages == order]
    assert len(complete) >= 0.999 * len(frames) and len(complete) == len(by_frame)
    staged = sum(1 for ev in trace.events if stage_kernel(ev[2]))
    assert len(trace.assigned) >= 0.999 * staged
    print("other kernels a frame:", json.dumps(trace.other_kernels()))


@pytest.mark.chip
def test_replay_kernels_map_onto_the_chunk_graphs_stage_order(cuda):
    cfg, st, trace = _traced("stream", cuda)
    n = st.traffic["frames_per_call"]
    order = st.engine.chunk_graphs[n].stages
    assert order == ((*(s.name for s in yardstick.stages(cfg)), "finish") * n)
    replays = [s for s in trace.spans if s.name == "chunk.replay"]
    launched = Counter(trace.calls[ev[3]][2] for ev in trace.events
                       if stage_kernel(ev[2]) and ev[3] in trace.calls)
    print(f"{len(replays)} replay spans; stage kernels by the runtime call that launched "
          f"them: {dict(launched)}")
    assert replays and trace.frames() == n * len(replays)
    kernel = _kernel_of(cfg)
    assert all(kernel[a.stage] in a.event[2] for a in trace.assigned)
    staged = sum(1 for ev in trace.events if stage_kernel(ev[2]))
    assert len(trace.assigned) == staged
    table = trace.stage_table(cfg)
    assert [r["launches_per_frame"] for r in table] == [1.0] * len(table)
