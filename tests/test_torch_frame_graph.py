"""The frame graph of ``FusedTransfer.stylize_prepacked``.

On CUDA every call replays one CUDA graph of a frame's conv stage launches and
``finish`` (:class:`FrameGraph`), its stem node pointed at the call's frame
pack; on the CPU, and while the stream is being captured, the stage loop runs.
The CPU tests hold the dispatch and the capture's bookkeeping (the CUDA graph
replaced by a stand-in); the card tests (the ``card`` fixture skips them
without a CUDA card) hold the graph's frames bit-equal to the stage loop's,
``unpack_frame(stylize_prepacked_raw(p)).float()[None]``.  This file imports
no JAX; on the card: ``python -m pytest tests/test_torch_frame_graph.py``.
"""

import contextlib

import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import plan_from_config
from realtime_style_transfer_torch.models.transfer import StyleTransferNet
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops.fused_transfer import FrameGraph, FusedTransfer
from realtime_style_transfer_torch.ops.kernels import unpack_frame
from realtime_style_transfer_torch.tracing import spans
from realtime_style_transfer_torch.weights import to_flax

SPEC = "rst-192-24-16-17"  # the CPU tests' size
N_PACKS = 16


def _engine(spec, device, *, num_styles=1, seed=0, quant=None, n_packs=2):
    """A seeded engine, ``n_packs`` distinct seeded frame packs on its
    device and two prepared styles."""
    plan = plan_from_config(ShapeConfig.from_spec(spec, num_styles=num_styles))
    g = torch.Generator().manual_seed(seed)
    variables = to_flax(StyleTransferNet(plan, num_styles, generator=g).state_dict())
    eng = FusedTransfer(variables, plan, num_styles=num_styles, device=device)
    h, w, _ = plan.output_shape
    packs = [eng.pack_frame(torch.rand((1,) + tuple(plan.input_shape), generator=g))
             for _ in range(n_packs)]

    def style():
        sp = torch.rand((1, num_styles, plan.num_style_parameters), generator=g) * 0.4 + 0.8
        weights = torch.rand((1, h, w, 1), generator=g) if num_styles == 2 else None
        return sp, weights

    styles = [style() for _ in range(2)]
    if quant is not None:
        scales = eng.calibrate_act_scales(packs[:2], eng.prepare_style(*styles[0]))
        eng = FusedTransfer(variables, plan, device=device, quant=quant, act_scales=scales)
    return eng, packs, [eng.prepare_style(*s) for s in styles]


def _eager(eng, packed, prepared):
    """The stage loop's frame, as ``stylize_prepacked`` returns it."""
    raw = eng.stylize_prepacked_raw(packed, prepared)
    return unpack_frame(raw, eng.plan.expand_blocks[-1][0]).float()[None]


@pytest.fixture(scope="module")
def cpu_engine():
    return _engine(SPEC, "cpu")


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_cpu_frames_run_the_stage_loop_with_its_spans(cpu_engine):
    eng, packs, (prep, _) = cpu_engine
    kernels.reset_launch_counts()
    with spans.recording() as record:
        got = eng.stylize_prepacked(packs[0], prep)
    assert torch.equal(got, _eager(eng, packs[0], prep))
    assert eng.frame_graph is None and kernels.replay_graph.replays == 0
    stages = [f"stage.{step.stage.name}" for step in eng.steps] + ["stage.finish"]
    assert [(s.name, record[s.parent].name if s.parent >= 0 else None) for s in record] == \
        [("frame", None)] + [(n, "frame") for n in ["frame.prep", *stages, "frame.unpack"]]


def test_dispatch_takes_the_stage_loop_on_the_cpu_and_while_capturing(cpu_engine, monkeypatch):
    eng = cpu_engine[0]
    assert not eng._frame_graph_engages()
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    for capturing in (True, False):
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda c=capturing: c)
        assert eng._frame_graph_engages() is not capturing


class _Graph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU."""

    def __init__(self, keep_graph=False):
        self.keep_graph = keep_graph
        self.instantiated = False

    def raw_cuda_graph(self):
        assert self.keep_graph
        return 0x1000

    def instantiate(self):
        self.instantiated = True

    def raw_cuda_graph_exec(self):
        assert self.instantiated
        return 0x2000


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The CUDA graph calls of the captures replaced by stand-ins: the
    recorded frames run on the CPU; ``found`` logs the node lookups."""
    found = []

    def input_node(raw_graph, x):
        found.append((raw_graph, x))
        return 0x3000

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(kernels, "graph_input_node", input_node)
    return found


def test_capture_records_one_frame_in_the_chunk_graphs_stage_order(cpu_engine,
                                                                   stand_in_graphs):
    eng, packs, (prep, _) = cpu_engine
    fg = eng._capture_frame(packs[0], prep)
    chunk = eng._capture_chunk(torch.stack(packs), prep)
    assert isinstance(fg, FrameGraph)
    assert fg.stages == tuple(step.stage.name for step in eng.steps) + ("finish",)
    assert fg.stages * len(packs) == chunk.stages
    # the stem's node is looked up by the caller's pack, in the recorded graph
    assert stand_in_graphs == [(0x1000, packs[0].data_ptr())]
    assert (fg.node, fg.graph_exec, fg.x) == (0x3000, 0x2000, packs[0].data_ptr())
    assert fg.graph.keep_graph and fg.graph.instantiated
    # the style is read through copies; the frame lands in the static output
    assert torch.equal(fg.prepared.table, prep.table)
    assert fg.prepared.table.data_ptr() != prep.table.data_ptr()
    assert torch.equal(fg.out, eng.stylize_prepacked_raw(packs[0], prep))


@pytest.mark.parametrize("num_styles", [1, 2])
def test_capture_counts_the_blending_calls_it_records(stand_in_graphs, num_styles):
    """A dual frame blends at every stage that applies a CIN (12 of the 16)
    and in the finish; a one-style frame nowhere."""
    eng, packs, (prep, _) = _engine(SPEC, "cpu", num_styles=num_styles, seed=3)
    fg = eng._capture_frame(packs[0], prep)
    chunk = eng._capture_chunk(torch.stack(packs), prep)
    blends = 12 + 1 if num_styles == 2 else 0
    assert fg.captured["blends"] == blends
    assert chunk.captured["blends"] == blends * len(packs)


def test_set_input_repoints_the_stem_only_when_the_pack_moves(cpu_engine, monkeypatch):
    eng, packs, (prep, _) = cpu_engine
    calls = []
    monkeypatch.setattr(kernels, "set_graph_input", lambda *a: calls.append(a))
    fg = FrameGraph(None, prep, packs[0], {}, (), 0x3000, 0x2000, packs[0].data_ptr())
    fg.set_input(packs[0])
    assert calls == []
    fg.set_input(packs[1])
    fg.set_input(packs[1])
    fg.set_input(packs[0])
    assert calls == [(0x2000, 0x3000, packs[1].data_ptr()), (0x2000, 0x3000, packs[0].data_ptr())]
    assert fg.x == packs[0].data_ptr()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frame graph records the stage kernels")
    return torch.device("cuda")


_KINDS = {
    "bf16": dict(spec="rst-960-120-128-17"),
    "dual": dict(spec="rst-960-120-128-17", num_styles=2),
    "int8": dict(spec="rst-960-120-128-17", quant="int8"),
    "rst1920": dict(spec="rst-1920-120-128-17"),
}


@pytest.fixture(scope="module")
def card_engines(card):
    made = {}

    def get(kind):
        if kind not in made:
            made.clear()   # one engine's packs on the card at a time
            kw = dict(_KINDS[kind])
            made[kind] = _engine(kw.pop("spec"), card, seed=list(_KINDS).index(kind) + 7,
                                 n_packs=N_PACKS, **kw)
        return made[kind]

    return get


@pytest.mark.parametrize("kind", list(_KINDS))
def test_graph_frames_equal_the_stage_loop_bit_for_bit(card_engines, kind):
    eng, packs, (prep, prep2) = card_engines(kind)
    want = [_eager(eng, p, prep) for p in packs]
    n_st = len(eng.steps)
    assert n_st == (18 if kind == "rst1920" else 16)
    kernels.reset_launch_counts()
    # every call queued before any is read back: the outputs of calls in flight
    got = [eng.stylize_prepacked(p, prep) for p in packs]
    torch.cuda.synchronize()
    fg = eng.frame_graph
    # a dual frame blends at every stage that applies a CIN, and in the finish
    blends = sum(step.src >= 0 for step in eng.steps) + 1 if eng.num_styles == 2 else 0
    assert fg.captured == {"conv_stage": n_st, "finish": 1, "blends": blends}
    assert fg.stages == tuple(step.stage.name for step in eng.steps) + ("finish",)
    # the warm-up frame and the recorded one, then one replay a call
    assert (kernels.conv_stage.launches, kernels.finish.launches,
            kernels.replay_graph.replays) == (2 * n_st, 2, N_PACKS)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"{kind} pack {i}: {int((a != b).sum())} values differ"
    # three more calls, no synchronize between them, a second style switched in
    kernels.reset_launch_counts()
    three = [eng.stylize_prepacked(packs[3], prep2), eng.stylize_prepacked(packs[3], prep),
             eng.stylize_prepacked(packs[9], prep2)]
    assert (kernels.conv_stage.launches, kernels.finish.launches,
            kernels.replay_graph.replays) == (0, 0, 3)
    torch.cuda.synchronize()
    for a, b in zip(three, [_eager(eng, packs[3], prep2), want[3],
                            _eager(eng, packs[9], prep2)]):
        assert torch.equal(a, b)
    # a pinned host pack goes to the card first
    host = packs[5].cpu().pin_memory()
    assert torch.equal(eng.stylize_prepacked(host, prep), want[5])


def test_a_bad_pack_raises_the_stage_loops_error(card_engines):
    eng, packs, (prep, _) = card_engines("bf16")
    eng.stylize_prepacked(packs[0], prep)
    p = packs[0]
    flat = torch.empty(p.numel() + 8, dtype=p.dtype, device=p.device)
    bad = {"shape": p[:, :-8], "dtype": p.float(),
           "strides": p.transpose(0, 1).contiguous().transpose(0, 1),
           "alignment": flat[1:1 + p.numel()].view(p.shape)}
    for what, x in bad.items():
        with pytest.raises(ValueError) as eager:
            eng.stylize_prepacked_raw(x, prep)
        with pytest.raises(ValueError) as graph:
            eng.stylize_prepacked(x, prep)
        assert str(graph.value) == str(eager.value), what
    assert torch.equal(eng.stylize_prepacked(packs[1], prep), _eager(eng, packs[1], prep))


def test_a_call_while_the_stream_captures_runs_the_stage_loop(card_engines):
    eng, packs, (prep, _) = card_engines("bf16")
    want = _eager(eng, packs[2], prep)
    eng.stylize_prepacked(packs[0], prep)
    fg = eng.frame_graph
    kernels.reset_launch_counts()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, capture_error_mode="thread_local"):
        out = eng.stylize_prepacked(packs[2], prep)
    assert eng.frame_graph is fg and kernels.replay_graph.replays == 0
    assert kernels.conv_stage.launches == len(eng.steps) and kernels.finish.launches == 1
    outer.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(eng.stylize_prepacked(packs[2], prep), want)
