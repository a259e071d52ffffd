"""The control of each frame configuration comes out not correct on the card.

The control is the program's own int8 engine (``FusedTransfer(quant=
"int8")``, scales calibrated on the seed's pool), the nearest precision below
the configuration's bfloat16, served by the same traffic at the cell's own
size through the frame driver's run, which compares it with the reference
and decides ``correct`` as a benchmark run does.  Run on the card:
``python -m pytest rst_bench/tests -m chip``.
"""

import json

import pytest

from rst_bench import yardstick
from rst_bench.drivers import frames

CASES = [(spec, seed) for spec in ("rst-960-120-128-17", "rst-1920-120-128-17")
         for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)]


@pytest.mark.chip
@pytest.mark.parametrize("spec, seed", CASES)
def test_int8_control_fails_the_limit(cuda, spec, seed):
    cfg = yardstick.load_config(f"rst_bench/configs/{spec}.json")
    traffic = json.loads((yardstick.ROOT / "traffic" / "stream.json").read_text())
    outcome = frames.run(cfg, traffic, seed=seed, seconds=0.5, trace=False, device=cuda,
                         quant="int8")
    value, limit = outcome.checks["rms_err"]
    print(f"{spec} seed {seed}: int8 control rms_err {value} (limit {limit})")
    assert not outcome.correct
    assert value > limit
