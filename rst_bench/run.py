"""Run one cell of the benchmark once and print its result line.

    python3 rst_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic file under ``rst_bench/traffic/`` (which
names its driver under ``rst_bench/drivers/``) and, with ``--trace 1``, one
reader under ``rst_bench/metrics/`` for each per-layer metric of the cell
(``mfu.frames`` is ``metrics/mfu_frames.py``).  The last line of
standard output is one JSON object; the numbers compared to decide
``correct`` are the last lines of standard error and the last key of it.

The run exits non-zero and prints no result where there is no CUDA device,
fewer than the cell asks for, or where, once the window has closed, the
process holds a module of JAX, flax or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here to the window's first frame

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this directory

FORBIDDEN = ("jax", "jaxlib", "flax", "realtime_style_transfer_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, whole, is JAX's, flax's or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({name for name in names if name.split(".")[0] in FORBIDDEN})


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def card() -> dict:
    """The card's power limit and SM clocks, from ``nvidia-smi``."""
    query = "power.limit,clocks.sm,clocks.max.sm"
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return {"nvidia_smi": "not measured"}
    return dict(zip(("power_limit_w", "sm_clock_mhz", "max_sm_clock_mhz"),
                    (v.strip() for v in line.split(","))))


def result(bench: dict, cell: dict, outcome, *, trace: bool, device: dict) -> dict:
    """The result line of a run from its driver's outcome."""
    name = cell["name"]
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if in_cell(m, name):
                value = (outcome.window_start - T0 if m["name"] == "setup_s"
                         else outcome.end_to_end[m["name"]])
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if in_cell(m, name):
                reader = importlib.import_module(
                    "rst_bench.metrics." + m["name"].replace(".", "_"))
                value = reader.read(outcome)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.device_ops(),
                             "idle_gaps": outcome.trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"run: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    torch.set_num_threads(1)  # the window's work is on the card: keep the host's load to one thread
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run: {args.workload} needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from rst_bench.yardstick import load_config

    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_config(config["file"])
    traffic = json.loads((ROOT / "rst_bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = importlib.import_module(f"rst_bench.drivers.{traffic['driver']}")
    outcome = driver.run(cfg, traffic, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device=torch.device("cuda"))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes, **card()}
    line = result(bench, cell, outcome, trace=bool(args.trace), device=device)

    found = forbidden_modules()
    if found:
        print(f"run: the process holds {', '.join(found)}: the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    print("card: " + ", ".join(f"{k} {v}" for k, v in device.items()
                               if k not in ("busy_s", "window_s")), file=sys.stderr)
    if "traced_frames" in outcome.readings:
        r = outcome.readings
        print(f"tracing: {r['frames'] / r['window_s']} frames/s untraced, "
              f"{r['traced_frames'] / r['traced_window_s']} traced", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
