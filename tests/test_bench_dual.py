"""The two-style benchmark configuration on the CPU, at the small spec
``rst-192-24-16-17``: the port's ``FusedTransfer(num_styles=2)`` (the
kernels' plain versions) against the plain dual reference
(``rst_bench/reference/transfer_dual.py``) within the configuration's limit,
the reference tied to the one-style reference, the frame driver's
``correct`` on a sound run and on two faults, the dual yardstick's plane
bytes, the program's blend counters and the readers of the new metrics.
Imports no JAX."""

import json
import subprocess
import sys
import types

import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import plan_from_config
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer, PreparedStyle
from realtime_style_transfer_torch.tracing import spans
from rst_bench import inputs, run, yardstick, yardstick_dual
from rst_bench.drivers import frames_dual
from rst_bench.metrics import (blend_launches_per_frame_dual, conv_halo_kernel_roofline_dual,
                               conv_window_kernel_roofline_dual)
from rst_bench.outcome import Outcome
from rst_bench.reference import transfer as reference
from rst_bench.reference.transfer_dual import stylize_dual
from rst_bench.tracer import TraceSummary

SPEC = "rst-192-24-16-17"
DUAL = yardstick.load_config("rst_bench/configs/rst-960-120-128-17-dual.json")
SEEDS = (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23)


def small_config(spec: str = SPEC) -> dict:
    """The dual configuration's keys and limits at a small spec's shapes,
    from the program's plan."""
    p = plan_from_config(ShapeConfig.from_spec(spec, num_styles=2))
    return dict(DUAL, name=f"{spec}-dual", spec=spec, input_shape=list(p.input_shape),
                output_shape=list(p.output_shape), bottleneck_res_y=p.bottleneck_res_y,
                bottleneck_num_filters=p.bottleneck_num_filters,
                stem=list(p.contract_schedule[0]),
                contracts=[list(c) for c in p.contract_schedule[1:]],
                expands=[list(e) for e in p.expand_blocks[:-1]], final=list(p.expand_blocks[-1]),
                num_style_parameters=p.num_style_parameters)


def _traffic():
    traffic = json.loads((yardstick.ROOT / "traffic" / "dual-stream.json").read_text())
    traffic.update(pool_frames=3, check_frames=3)
    return traffic


def _engine(cfg, seed, num_styles=2):
    plan = plan_from_config(ShapeConfig.from_spec(cfg["spec"], num_styles=num_styles))
    return FusedTransfer(inputs.transfer_variables(cfg, seed, "cpu"), plan,
                         num_styles=num_styles, device="cpu")


# ---------------------------------------------------------------------------
# the program against the reference, and the reference against the one-style one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_stage_loop_is_within_the_limit_of_the_dual_reference(seed):
    cfg = small_config()
    engine = _engine(cfg, seed)
    styles = frames_dual.styles(cfg, seed, "cpu")
    weights = frames_dual.blend_map(cfg, seed, "cpu")
    content = inputs.content_frame(cfg, seed, 0, "cpu")
    out = engine.stylize_prepacked(engine.pack_frame(content),
                                   engine.prepare_style(styles, weights))
    ref = stylize_dual(cfg, inputs.transfer_variables(cfg, seed, "cpu"), content, styles,
                       weights)
    gap = (out - ref).square().mean().sqrt().item()
    assert 1e-4 < gap <= DUAL["limits"]["frames"]["rms_err"], gap


@pytest.mark.parametrize("style", [0, 1])
def test_a_constant_map_gives_the_one_style_reference(style):
    """The map at 0 everywhere is style 0 alone, at 1 everywhere style 1."""
    cfg = small_config()
    seed = SEEDS[0]
    variables = inputs.transfer_variables(cfg, seed, "cpu")
    styles = frames_dual.styles(cfg, seed, "cpu")
    content = inputs.content_frame(cfg, seed, 1, "cpu")
    h, w, _ = cfg["output_shape"]
    weights = torch.full((1, h, w, 1), float(style))
    got = stylize_dual(cfg, variables, content, styles, weights)
    want = reference.stylize(cfg, variables, content, styles[style])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_blend_map_has_broad_regions_of_each_style_alone():
    cfg = small_config("rst-960-120-128-17")
    m = frames_dual.blend_map(cfg, SEEDS[0], "cpu")
    assert m.shape == (1, 480, 960, 1) and m.dtype == torch.float32
    assert torch.equal(m, frames_dual.blend_map(cfg, SEEDS[0], "cpu"))
    assert 0.0 <= m.min().item() and m.max().item() <= 1.0
    alone = ((m == 0) | (m == 1)).float().mean().item()
    assert 0.2 < (m == 0).float().mean().item() < 0.5 and 0.2 < (m == 1).float().mean().item()
    assert 0.4 < alone < 0.8   # the rest: soft edges between the regions
    two = frames_dual.styles(cfg, SEEDS[0], "cpu")
    assert two.shape == (2, 2662) and not torch.equal(two[0], two[1])
    assert torch.equal(two[0], inputs.style_vector(cfg, SEEDS[0], "cpu"))


# ---------------------------------------------------------------------------
# the driver's correct
# ---------------------------------------------------------------------------


def _run(seed=SEEDS[1]):
    return frames_dual.run(small_config(), _traffic(), seed=seed, seconds=0.3, trace=False,
                           device="cpu")


def test_sound_dual_run_is_correct():
    outcome = _run()
    assert outcome.correct and outcome.failed == 0 and outcome.attempted >= 3
    assert outcome.checks["rms_err"][1] == DUAL["limits"]["frames"]["rms_err"]
    assert outcome.readings["blend_launches_per_frame"] is None   # no chunk graph on the CPU


def _swapped(prepare):
    def fault(self, style_params, style_weights=None):
        return prepare(self, torch.as_tensor(style_params).flip(0), style_weights)
    return fault


def _zeroed(prepare):
    def fault(self, style_params, style_weights=None):
        prepared = prepare(self, style_params, style_weights)
        return PreparedStyle(prepared.table, tuple(torch.zeros_like(p) for p in prepared.planes))
    return fault


@pytest.mark.parametrize("fault", [_swapped, _zeroed], ids=["styles_swapped", "planes_zeroed"])
def test_a_wrong_blend_is_not_correct_on_every_checked_frame(monkeypatch, fault):
    monkeypatch.setattr(FusedTransfer, "prepare_style", fault(FusedTransfer.prepare_style))
    outcome = _run()
    assert not outcome.correct
    assert outcome.failed == 3   # every checked frame


# ---------------------------------------------------------------------------
# the yardstick, the counters and the readers
# ---------------------------------------------------------------------------


def test_plane_bytes_at_rst_960():
    assert yardstick_dual.plane_bytes(DUAL) == 2_649_600 == 2 * (
        10 * 120 * 240 + 240 * 480 + 2 * 480 * 960)
    assert [st.name for st in yardstick_dual.blending(DUAL)] == \
        [f"res{i // 2}{'ab'[i % 2]}" for i in range(1, 10)] + ["e0", "e1", "final"]
    one, two = yardstick.path_bounds(DUAL), yardstick_dual.path_bounds(DUAL)
    for kernel, (bound, n) in one.items():
        assert two[kernel][1] == n and bound < two[kernel][0] < 1.01 * bound
    ops, n_bytes = yardstick.finish_work(DUAL)
    assert yardstick_dual.finish_work_dual(DUAL) == (ops, n_bytes + 2 * 480 * 960 + 2 * 4 * 3)


@pytest.mark.parametrize("num_styles, blends", [(1, 0), (2, 12)])
def test_stage_loop_counts_the_blending_calls(num_styles, blends):
    cfg = small_config()
    engine = _engine(cfg, SEEDS[2], num_styles)
    style = frames_dual.styles(cfg, SEEDS[2], "cpu")[:num_styles]
    prepared = engine.prepare_style(
        style, frames_dual.blend_map(cfg, SEEDS[2], "cpu") if num_styles == 2 else None)
    packs = [engine.pack_frame(inputs.content_frame(cfg, SEEDS[2], i, "cpu")) for i in range(2)]
    kernels.reset_launch_counts()
    for p in packs:
        engine.stylize_prepacked(p, prepared)
    assert (kernels.conv_stage.blends, kernels.finish.blends) == (2 * blends, 2 * (blends > 0))
    kernels.reset_launch_counts()
    assert (kernels.conv_stage.blends, kernels.finish.blends) == (0, 0)


@pytest.mark.parametrize("num_styles", [1, 2])
def test_weight_planes_have_a_span(num_styles):
    cfg = small_config()
    engine = _engine(cfg, SEEDS[0], num_styles)
    style = frames_dual.styles(cfg, SEEDS[0], "cpu")[:num_styles]
    weights = frames_dual.blend_map(cfg, SEEDS[0], "cpu") if num_styles == 2 else None
    with spans.recording() as record:
        engine.prepare_style(style, weights)
    assert [(s.name, s.parent, s.frame) for s in record] == \
        [("style.planes", -1, -1)] * (num_styles == 2)
    assert all(s.end_ns >= s.start_ns > 0 for s in record)


def test_blend_reader_takes_the_chunk_graphs_count_or_none():
    def state(captured):
        graph = types.SimpleNamespace(captured=captured)
        return types.SimpleNamespace(engine=types.SimpleNamespace(chunk_graphs={3: graph}),
                                     traffic={"frames_per_call": 3})

    assert frames_dual.blend_launches_per_frame(
        state({"conv_stage": 48, "finish": 3, "blends": 39})) == 13.0
    # a program without the blend counters: the metric is absent, not an error
    assert frames_dual.blend_launches_per_frame(state({"conv_stage": 48, "finish": 3})) is None
    o = Outcome(DUAL, 3, 0, 0.0, 0, {}, {"blend_launches_per_frame": 13.0}, {})
    assert blend_launches_per_frame_dual.read(o) == 13.0
    assert blend_launches_per_frame_dual.read(Outcome(DUAL, 3, 0, 0.0, 0, {}, {}, {})) is None


def test_dual_rooflines_read_the_trace_against_the_dual_bounds():
    ms = 1_000_000
    device = [(0, ms, "void conv_halo_kernel<128, false>(P)"),
              (ms, 3 * ms, "void conv_window_kernel<8, false>(P)")]
    o = Outcome(DUAL, 1, 0, 0.0, 0, {}, {}, {}, trace=TraceSummary(device, [], window_s=1.0))
    for reader, kernel, seconds in ((conv_halo_kernel_roofline_dual, "conv_halo_kernel", 1e-3),
                                    (conv_window_kernel_roofline_dual, "conv_window_kernel",
                                     2e-3)):
        bound, per_frame = yardstick_dual.path_bounds(DUAL)[kernel]
        assert reader.read(o) == pytest.approx(100 * bound / per_frame / seconds)
        assert reader.read(Outcome(DUAL, 1, 0, 0.0, 0, {}, {}, {})) is None


def test_new_harness_modules_load_no_jax_and_the_reference_nothing_of_the_program():
    code = ("import rst_bench.reference.transfer_dual, rst_bench.yardstick_dual\n"
            "import sys; print(' '.join(sys.modules))")
    loaded = subprocess.run([sys.executable, "-c", code], cwd=yardstick.ROOT.parent,
                            capture_output=True, text=True, timeout=300, check=True).stdout.split()
    assert not [m for m in loaded if m.split(".")[0].startswith("realtime_style_transfer")]
    code = "import rst_bench.drivers.frames_dual\nimport sys; print(' '.join(sys.modules))"
    loaded = subprocess.run([sys.executable, "-c", code], cwd=yardstick.ROOT.parent,
                            capture_output=True, text=True, timeout=300, check=True).stdout.split()
    assert run.forbidden_modules(loaded) == []
