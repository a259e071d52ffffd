"""The control of the two-style configuration comes out not correct on the card.

The control is the program's own dual int8 engine (``FusedTransfer(
num_styles=2, quant="int8")``, scales calibrated on the seed's pool with both
styles and the map), the nearest precision below the configuration's
bfloat16, served by the cell's traffic at its own size through the dual
frame driver's run, which compares it with the dual reference and decides
``correct`` as a benchmark run does.  Run on the card:
``python -m pytest rst_bench/tests -m chip``.
"""

import json

import pytest

from rst_bench import yardstick
from rst_bench.drivers import frames_dual

SEEDS = (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203)


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_dual_int8_control_fails_the_limit(cuda, seed):
    cfg = yardstick.load_config("rst_bench/configs/rst-960-120-128-17-dual.json")
    traffic = json.loads((yardstick.ROOT / "traffic" / "dual-stream.json").read_text())
    outcome = frames_dual.run(cfg, traffic, seed=seed, seconds=0.5, trace=False, device=cuda,
                              quant="int8")
    value, limit = outcome.checks["rms_err"]
    print(f"dual seed {seed}: int8 control rms_err {value} (limit {limit})")
    assert not outcome.correct
    assert value > limit
