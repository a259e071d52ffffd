"""A run with its timed path broken comes out not correct.

The frame driver runs at a small spec on the CPU (the engine's plain
versions of the kernels; no card and no look for one), held to the rst-960
configuration's limit.  The one fault a frame cell can have among those a
benchmark must catch: an answer altered where it is produced, here in the
``finish`` that writes the packed frame out.
"""

import json

import pytest

from realtime_style_transfer_torch.ops import fused_transfer
from rst_bench import yardstick
from rst_bench.drivers import frames

from .conftest import spec_config


def _run(seed):
    cfg = spec_config("rst-192-24-16-17")
    cfg["limits"] = yardstick.load_config("rst_bench/configs/rst-960-120-128-17.json")["limits"]
    traffic = json.loads((yardstick.ROOT / "traffic" / "stream.json").read_text())
    traffic.update(pool_frames=3, check_frames=3)
    return frames.run(cfg, traffic, seed=seed, seconds=0.3, trace=False, device="cpu")


def test_sound_run_is_correct():
    outcome = _run(2 ** 31 + 11)
    assert outcome.correct and outcome.failed == 0 and outcome.attempted >= 3


@pytest.mark.parametrize("rows", [2, 8])
def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch, rows):
    finish = fused_transfer.finish

    def altered(x, prologue, out):
        finish(x, prologue, out)
        out[:rows] += 0.25  # a band of the packed frame, as a wrong tile would
        return out

    monkeypatch.setattr(fused_transfer, "finish", altered)
    outcome = _run(2 ** 31 + 11)
    assert not outcome.correct
    assert outcome.failed == 3  # every checked frame
