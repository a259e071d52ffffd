"""The plain reference against the port's plain paths at small specs, and the
configuration files against the program's plans."""

import json

import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import plan_from_config
from realtime_style_transfer_torch.models.transfer import StyleTransferNet
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.weights import from_flax
from rst_bench import inputs, yardstick
from rst_bench.reference import transfer as reference

from .conftest import spec_config

SMALL = ("rst-192-24-16-17", "rst-192-12-16-17")  # two and three contracts


@pytest.mark.parametrize("spec", SMALL)
def test_reference_equals_the_eager_f32_net(spec):
    cfg = spec_config(spec)
    variables = inputs.transfer_variables(cfg, 3, "cpu")
    style = inputs.style_vector(cfg, 3, "cpu")
    content = inputs.content_frame(cfg, 3, 0, "cpu")
    net = StyleTransferNet(plan_from_config(ShapeConfig.from_spec(spec)))
    net.load_state_dict(from_flax(variables, net))
    with torch.no_grad():
        eager = net(content, style[None, None])
    ref = reference.stylize(cfg, variables, content, style)
    assert ref.shape == (1, *cfg["output_shape"])
    torch.testing.assert_close(ref, eager, rtol=0, atol=2e-5)


@pytest.mark.parametrize("spec", SMALL)
def test_reference_is_near_the_fused_engine_plain_path(spec):
    """bf16 storage between stages: the gaps of the benchmark's bf16 frames."""
    cfg = spec_config(spec)
    variables = inputs.transfer_variables(cfg, 5, "cpu")
    style = inputs.style_vector(cfg, 5, "cpu")
    content = inputs.content_frame(cfg, 5, 1, "cpu")
    engine = FusedTransfer(variables, plan_from_config(ShapeConfig.from_spec(spec)), device="cpu")
    out = engine.stylize_prepacked(engine.pack_frame(content), engine.prepare_style(style))
    gap = (out - reference.stylize(cfg, variables, content, style)).square().mean().sqrt()
    assert 1e-4 < gap.item() < 0.03


@pytest.mark.parametrize("spec", ("rst-960-120-128-17", "rst-1920-120-128-17"))
def test_configuration_file_is_the_programs_plan(spec):
    cfg = json.loads((yardstick.ROOT / "configs" / f"{spec}.json").read_text())
    assert {k: cfg[k] for k in spec_config(spec) if k != "limits"} == \
        {k: v for k, v in spec_config(spec).items() if k != "limits"}
    assert cfg["reduced"] == []


def test_inputs_repeat_for_a_seed_and_change_with_it():
    cfg = spec_config("rst-192-24-16-17")
    seed = 2 ** 31 + 17
    a = inputs.content_frame(cfg, seed, 2, "cpu")
    assert torch.equal(a, inputs.content_frame(cfg, seed, 2, "cpu"))
    assert not torch.equal(a, inputs.content_frame(cfg, seed + 1, 2, "cpu"))
    va, vb = (inputs.transfer_variables(cfg, s, "cpu") for s in (seed, seed + 1))
    assert va["params"]["contract_0_conv"]["kernel"].shape == \
        vb["params"]["contract_0_conv"]["kernel"].shape
    assert torch.equal(inputs.style_vector(cfg, seed, "cpu"), inputs.style_vector(cfg, seed, "cpu"))
