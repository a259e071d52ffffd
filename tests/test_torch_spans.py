"""The port's span recorder (``tracing/spans.py``) and the spans of the served
frame, on the CPU: the engine runs its stage kernels' plain versions there,
so the frame path's spans are all there but ``launch``, which only the
kernels' ctypes calls open."""

import tracemalloc

import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import make_inference_model
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.tracing import spans
from realtime_style_transfer_torch.weights import to_flax

SPEC = "rst-192-24-16-17"


@pytest.fixture(scope="module")
def engine():
    model = make_inference_model(ShapeConfig.from_spec(SPEC), seed=0, device="cpu")
    eng = FusedTransfer(to_flax(model.transfer.state_dict()), model.plan, device="cpu")
    g = torch.Generator().manual_seed(0)
    packs = torch.stack([
        eng.pack_frame(torch.rand((1,) + tuple(model.plan.input_shape), generator=g))
        for _ in range(2)])
    prepared = eng.prepare_style(torch.rand(model.plan.num_style_parameters, generator=g) + 0.5)
    return eng, packs, prepared


def _tree(record):
    """(name, parent's name or None, frame) of each span."""
    return [(s.name, record[s.parent].name if s.parent >= 0 else None, s.frame)
            for s in record]


def test_spans_nest_with_parents_and_frame_ids():
    with spans.recording() as record:
        spans.begin("outside")
        spans.end()
        for _ in range(2):
            spans.begin_frame("frame")
            spans.begin("stage.a")
            spans.begin("launch")
            spans.end()
            spans.end()
            spans.begin("stage.b")
            spans.end()
            spans.end()
    assert _tree(record) == [
        ("outside", None, -1),
        ("frame", None, 0), ("stage.a", "frame", 0), ("launch", "stage.a", 0),
        ("stage.b", "frame", 0),
        ("frame", None, 1), ("stage.a", "frame", 1), ("launch", "stage.a", 1),
        ("stage.b", "frame", 1)]
    assert all(isinstance(s, spans.Span) for s in record)
    for s in record:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = record[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert record[1].end_ns <= record[5].start_ns


def test_a_frame_that_raised_leaves_its_spans_open_and_the_next_frame_at_the_top():
    with spans.recording() as record:
        spans.begin_frame("frame")
        spans.begin("stage.a")   # its call raised: neither span is closed
        spans.begin_frame("frame")
        spans.end()
    assert [(s.name, s.parent, s.frame, s.end_ns == 0) for s in record] == [
        ("frame", -1, 0, True), ("stage.a", 0, 0, True), ("frame", -1, 1, False)]


def test_recording_is_off_outside_its_block_and_not_reentrant():
    assert not spans.on
    with spans.recording() as record:
        assert spans.on
        with pytest.raises(RuntimeError, match="already"):
            with spans.recording():
                pass
    assert not spans.on and record == []
    with pytest.raises(KeyError):
        with spans.recording():
            raise KeyError("inside")
    assert not spans.on


def test_off_the_frame_path_records_and_allocates_nothing(engine):
    eng, packs, prepared = engine
    eng.stylize_prepacked(packs[0], prepared)   # warm
    with spans.recording() as record:
        pass
    # the recorder's state is untouched by a frame while it is off
    state = (spans._record, list(spans._open), spans._frame)
    eng.stylize_prepacked(packs[0], prepared)
    assert (spans._record, spans._open, spans._frame) == state and record == []

    def sites():
        for _ in range(1000):
            if spans.on:
                spans.begin("stage.x")
            if spans.on:
                spans.end()

    sites()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        sites()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename in (spans.__file__, __file__) and d.size_diff > 0]
    assert grown == []


def test_stylize_prepacked_opens_one_frame_with_prep_a_span_a_stage_and_unpack(engine):
    eng, packs, prepared = engine
    with spans.recording() as record:
        out = eng.stylize_prepacked(packs[0], prepared)
        eng.stylize_prepacked(packs[1], prepared)
    assert tuple(out.shape) == (1,) + tuple(eng.plan.output_shape)
    stage_names = [f"stage.{step.stage.name}" for step in eng.steps] + ["stage.finish"]
    want = [("frame", None)] + [(n, "frame") for n in
                                ["frame.prep", *stage_names, "frame.unpack"]]
    assert [t[:2] for t in _tree(record)] == want * 2
    assert [s.frame for s in record] == [0] * len(want) + [1] * len(want)
    assert not any(s.name == "launch" for s in record)   # no ctypes call on the CPU
    assert len(eng.steps) == 16


def test_stylize_prepacked_chunk_opens_one_chunk_span_a_call(engine):
    eng, packs, prepared = engine
    with spans.recording() as record:
        out = eng.stylize_prepacked_chunk(packs, prepared)
    assert tuple(out.shape) == (2,) + tuple(eng.plan.output_shape)
    tree = _tree(record)
    assert tree[0] == ("chunk", None, 0) and tree[-1] == ("chunk.unpack", "chunk", 0)
    assert [t[0] for t in tree].count("stage.finish") == 2
    assert [t[0] for t in tree].count("frame.prep") == 2
    assert all(parent == "chunk" and frame == 0 for _n, parent, frame in tree[1:])


def test_calibration_records_no_stage_spans(engine):
    eng, packs, prepared = engine
    with spans.recording() as record:
        eng.calibrate_act_scales([packs[0]], prepared)
    assert record == []


def test_spans_change_no_output(engine):
    eng, packs, prepared = engine
    off = eng.stylize_prepacked(packs[0], prepared)
    with spans.recording():
        on = eng.stylize_prepacked(packs[0], prepared)
    assert torch.equal(off, on)
