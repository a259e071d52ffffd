"""The port stays clean of JAX: importing every module of
``realtime_style_transfer_torch`` and ``chip_smoke`` loads none of ``jax``,
``flax``, ``optax``, ``orbax`` or ``realtime_style_transfer_tpu``.  The imports run in a
fresh interpreter, because this test process has JAX loaded already."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "realtime_style_transfer_tpu")

PROBE = r"""
import importlib, json, pkgutil, sys
import realtime_style_transfer_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted({m.split(".")[0] for m in sys.modules} & set(sys.argv[1:]))
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def test_port_and_chip_smoke_import_nothing_of_jax():
    run = subprocess.run([sys.executable, "-c", PROBE, *FORBIDDEN], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert run.returncode == 0, run.stderr[-3000:]
    import json

    report = json.loads(run.stdout.strip().splitlines()[-1])
    assert "realtime_style_transfer_torch.models.training" in report["modules"]
    assert "realtime_style_transfer_torch.ops.cin" in report["modules"]
    assert "realtime_style_transfer_torch.trainer" in report["modules"]
    assert "realtime_style_transfer_torch.train_network" in report["modules"]
    assert "realtime_style_transfer_torch.models.backbones.efficientnet" in report["modules"]
    for name in ("distributed", "mesh", "train", "infer"):
        assert f"realtime_style_transfer_torch.parallel.{name}" in report["modules"]
    assert report["loaded"] == []
