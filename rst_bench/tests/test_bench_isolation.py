"""Nothing the benchmark loads is JAX, flax or the JAX package, and the
reference loads nothing of the program."""

import subprocess
import sys

import pytest

from rst_bench import run, yardstick


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=yardstick.ROOT.parent, capture_output=True, text=True, timeout=300,
                         check=True)
    return out.stdout.split()


@pytest.mark.parametrize("module", ["rst_bench.run", "rst_bench.drivers.frames",
                                    "rst_bench.readings", "rst_bench.reference.transfer"])
def test_harness_loads_no_jax(module):
    loaded = _modules_after(f"import {module}")
    assert run.forbidden_modules(loaded) == []


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import rst_bench.reference.transfer, rst_bench.yardstick, "
                            "rst_bench.inputs")
    assert not [m for m in loaded if m.split(".")[0].startswith("realtime_style_transfer")]


def test_forbidden_names_compare_the_whole_top_level_name():
    assert run.forbidden_modules(["realtime_style_transfer_torch.ops", "jaxtyping",
                                  "flaxen"]) == []
    assert run.forbidden_modules(["jax.numpy", "flax", "realtime_style_transfer_tpu.config",
                                  "jaxlib"]) == ["flax", "jax.numpy", "jaxlib",
                                                 "realtime_style_transfer_tpu.config"]
