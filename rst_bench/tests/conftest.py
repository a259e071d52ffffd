"""Tests of the benchmark harness.  Tests marked ``chip`` need a CUDA card;
they decide so in the ``cuda`` fixture and skip without one."""

import pytest

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import plan_from_config


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda")


def spec_config(spec: str) -> dict:
    """A configuration dict of the harness's format for any spec, from the
    program's own plan (the small specs of the CPU tests)."""
    p = plan_from_config(ShapeConfig.from_spec(spec))
    return dict(name=spec, spec=spec, input_shape=list(p.input_shape),
                output_shape=list(p.output_shape), bottleneck_res_y=p.bottleneck_res_y,
                bottleneck_num_filters=p.bottleneck_num_filters,
                stem=list(p.contract_schedule[0]),
                contracts=[list(c) for c in p.contract_schedule[1:]], residual_blocks=5,
                expands=[list(e) for e in p.expand_blocks[:-1]], final=list(p.expand_blocks[-1]),
                num_styles=1, num_style_parameters=p.num_style_parameters, cin_epsilon=1e-5,
                bn_epsilon=1e-3, limits={"frames": {"rms_err": None}})
