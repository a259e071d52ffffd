"""The frozen counts equal the program's own bounds (``ops/bounds.py``) today."""

import pytest

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import plan_from_config
from realtime_style_transfer_torch.ops import bounds
from rst_bench import yardstick

SPECS = ("rst-960-120-128-17", "rst-1920-120-128-17")


@pytest.mark.parametrize("spec", SPECS)
def test_stage_counts_equal_bounds_py(spec):
    cfg = yardstick.load_config(f"rst_bench/configs/{spec}.json")
    work = bounds.plan_stage_work(spec)
    stages = yardstick.stages(cfg)
    assert [st.name for st in stages] == [k for k in work if k != "finish"]
    for st in stages:
        assert (st.ops, st.bytes) == work[st.name], st.name
        assert yardstick.bound_s(st.ops, st.bytes) * 1e3 == pytest.approx(
            bounds.bound_ms(*work[st.name])[0], rel=1e-12)
    assert yardstick.finish_work(cfg) == work["finish"]


@pytest.mark.parametrize("spec", SPECS)
def test_frame_flops_equal_bounds_py(spec):
    cfg = yardstick.load_config(f"rst_bench/configs/{spec}.json")
    ops, _ = bounds.frame_work(plan_from_config(ShapeConfig.from_spec(spec)))
    assert yardstick.frame_flops(cfg) == ops


def test_flagship_frame_is_127_3_gflop():
    cfg = yardstick.load_config("rst_bench/configs/rst-960-120-128-17.json")
    assert round(yardstick.frame_flops(cfg) / 1e9, 1) == 127.3


@pytest.mark.parametrize("spec, window, halo", [("rst-960-120-128-17", 2, 14),
                                                ("rst-1920-120-128-17", 2, 16)])
def test_path_bounds_split_the_frame(spec, window, halo):
    cfg = yardstick.load_config(f"rst_bench/configs/{spec}.json")
    paths = yardstick.path_bounds(cfg)
    assert paths["conv_window_kernel"][1] == window and paths["conv_halo_kernel"][1] == halo
    total = sum(yardstick.bound_s(st.ops, st.bytes) for st in yardstick.stages(cfg))
    assert sum(b for b, _ in paths.values()) == pytest.approx(total, rel=1e-12)


def test_mfu_frames_reads_frames_and_span_from_the_trace():
    from rst_bench.metrics import mfu_frames
    from rst_bench.outcome import Outcome
    from rst_bench.tracer import TraceSummary

    cfg = yardstick.load_config("rst_bench/configs/rst-960-120-128-17.json")
    ms = 1_000_000
    # two frames, a stage kernel and a finish each, one idle millisecond between
    device = [(0, ms, "conv_halo_kernel<128>"), (ms, 2 * ms, "finish_kernel(...)"),
              (3 * ms, 4 * ms, "conv_halo_kernel<128>"), (4 * ms, 5 * ms, "finish_kernel(...)")]
    trace = TraceSummary(device, [], window_s=1.0)  # the host's window is not read
    assert trace.span_s == pytest.approx(5e-3) and trace.busy_s == pytest.approx(4e-3)
    o = Outcome(cfg, 2, 0, 0.0, 0, {}, {"frames": 7, "window_s": 3.0}, {}, trace=trace)
    want = 100 * yardstick.frame_flops(cfg) * 2 / 5e-3 / yardstick.PEAK_FLOPS["bf16"]
    assert mfu_frames.read(o) == pytest.approx(want)
    assert mfu_frames.read(Outcome(cfg, 2, 0, 0.0, 0, {}, {}, {}, trace=None)) is None
